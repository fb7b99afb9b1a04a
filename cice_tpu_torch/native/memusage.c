/* Process memory usage probes.
 *
 * Native equivalent of the reference's C helper
 * cicecore/cicedyn/infrastructure/ice_memusage_gptl.c (241 LoC): report
 * resident-set high-water and current usage so the driver can print the
 * memory line at init/diagnostic steps. Built as a tiny shared object and
 * loaded via ctypes (a copy of the JAX package's source).
 */

#include <stdio.h>
#include <string.h>
#include <sys/resource.h>
#include <unistd.h>

/* High-water RSS in MB (ru_maxrss is KB on Linux). */
double cice_memusage_highwater(void) {
    struct rusage ru;
    if (getrusage(RUSAGE_SELF, &ru) != 0) return -1.0;
    return (double)ru.ru_maxrss / 1024.0;
}

/* Current RSS in MB from /proc/self/statm (pages). */
double cice_memusage_current(void) {
    long rss_pages = 0;
    FILE *f = fopen("/proc/self/statm", "r");
    if (!f) return -1.0;
    if (fscanf(f, "%*s %ld", &rss_pages) != 1) { fclose(f); return -1.0; }
    fclose(f);
    return (double)rss_pages * (double)sysconf(_SC_PAGESIZE) / (1024.0 * 1024.0);
}
