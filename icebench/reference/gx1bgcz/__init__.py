"""The reference of the configurations with CICE's vertical z-tracer
biogeochemistry (`set_nml.bgcz`) under NCAR monthly forcing: the `ice`
reference's frozen modules, and frozen copies of the program's plain
paths that `ice` does not carry: the brine height, the z tracers on the
brine column (with the mushy liquid fraction they read), the tracer
registry with their groups, the tracer update of therm1, the NCAR
atmosphere and ocean-climatology readers. `reference.py` holds its
`ReferenceModel`; `step.check_supported` refuses what it does not carry.
"""
