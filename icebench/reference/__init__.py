"""The plain references that `icebench` holds the program against, one
directory each, named by a configuration's "reference" key
(`catalog.reference`), and the comparison that decides `correct`
(`compare.py`), which they share.

A reference is plain PyTorch that imports nothing of the program: it
never changes with the program, so a later change to the program that
gives other answers shows against it. `reference/<name>/reference.py`
defines its `ReferenceModel`; `ice/` is the frozen copy of the program's
plain path that the first configurations name.
"""
