/* Asynchronous file writer: a small native IO runtime that lets the model
 * loop hand off history/restart payloads and return to compute at once
 * (the port's copy of the JAX package's asyncwriter.c, with the restart
 * pointer written by the worker).
 *
 * The latency-hiding role of the reference's parallel IO backend (io_pio2,
 * cicecore/cicedyn/infrastructure/io/io_pio2/ice_pio.F90:591): host-side
 * byte payloads, written by a pthread worker pool draining a FIFO while the
 * card keeps stepping.
 *
 * Exported (ctypes) API:
 *   void *cice_aw_start(int nthreads);
 *   int   cice_aw_submit(void *h, const char *path, const void *data,
 *                        size_t n, const char *then_path,
 *                        const char *then_text);
 *   long  cice_aw_flush(void *h);      -- block until drained; cumulative errors
 *   long  cice_aw_pending(void *h);    -- queued + in-flight jobs
 *   void  cice_aw_stop(void *h);       -- flush, join, free
 *
 * Submit does not copy the payload: the caller keeps the buffer alive and
 * unchanged until the job is written (until cice_aw_pending returns 0 or
 * cice_aw_flush returns). A copy would cost as much as the write it hides:
 * both move the bytes through memory once, and the page cache takes a
 * write at memory speed. Writes go to <path>.tmp then rename(2), so a
 * reader never observes a partial file.
 *
 * A job may carry a follow-on: `then_text` written to `then_path` (a
 * restart's pointer file) by the same worker after the payload has been
 * renamed into place, so the pointer never names a file that is not on
 * disk. Follow-ons are written in submission order: each takes a ticket at
 * submit and waits until every earlier ticket is done, so two workers
 * cannot leave the pointer on an older restart. A follow-on whose payload
 * failed is skipped (and counted as an error).
 */

#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct aw_job {
    char *path;
    const unsigned char *data;    /* the caller's buffer, not owned */
    size_t n;
    char *then_path;          /* NULL: no follow-on                         */
    char *then_text;
    long ticket;              /* order of the follow-on; -1 without one     */
    struct aw_job *next;
} aw_job;

typedef struct {
    pthread_mutex_t mu;
    pthread_cond_t cv_push;   /* signalled when a job is queued or stop set */
    pthread_cond_t cv_done;   /* signalled when a worker finishes a job or
                                 a follow-on                                */
    aw_job *head, *tail;
    long queued;              /* jobs in FIFO                               */
    long inflight;            /* jobs popped but not yet written            */
    long errors;              /* cumulative failed writes                   */
    long tickets;             /* follow-on tickets handed out               */
    long ticket_done;         /* follow-ons written or skipped, in order    */
    int stop;
    int nthreads;
    pthread_t *threads;
} aw_ctx;

static int aw_write_file(const char *path, const unsigned char *data, size_t n)
{
    size_t plen = strlen(path);
    char *tmp = (char *)malloc(plen + 5);
    if (!tmp) return -1;
    memcpy(tmp, path, plen);
    memcpy(tmp + plen, ".tmp", 5);

    FILE *f = fopen(tmp, "wb");
    if (!f) { free(tmp); return -1; }
    int ok = (n == 0) || (fwrite(data, 1, n, f) == n);
    ok = (fclose(f) == 0) && ok;
    if (ok)
        ok = (rename(tmp, path) == 0);
    else
        remove(tmp);
    free(tmp);
    return ok ? 0 : -1;
}

static void aw_free_job(aw_job *j)
{
    free(j->path);
    free(j->then_path);
    free(j->then_text);
    free(j);
}

static void *aw_worker(void *arg)
{
    aw_ctx *c = (aw_ctx *)arg;
    for (;;) {
        pthread_mutex_lock(&c->mu);
        while (!c->head && !c->stop)
            pthread_cond_wait(&c->cv_push, &c->mu);
        if (!c->head && c->stop) {
            pthread_mutex_unlock(&c->mu);
            return NULL;
        }
        aw_job *j = c->head;
        c->head = j->next;
        if (!c->head) c->tail = NULL;
        c->queued--;
        c->inflight++;
        pthread_mutex_unlock(&c->mu);

        int rc = aw_write_file(j->path, j->data, j->n);

        pthread_mutex_lock(&c->mu);
        if (rc != 0) c->errors++;
        if (j->ticket >= 0) {
            /* earlier tickets were popped first and are in flight: wait
               for them, then write this follow-on under the lock (it is a
               few bytes, and no two workers share its tmp file) */
            while (c->ticket_done != j->ticket)
                pthread_cond_wait(&c->cv_done, &c->mu);
            if (rc == 0) {
                if (aw_write_file(j->then_path,
                                  (const unsigned char *)j->then_text,
                                  strlen(j->then_text)) != 0)
                    c->errors++;
            } else {
                c->errors++;      /* the follow-on is not written */
            }
            c->ticket_done++;
        }
        c->inflight--;
        pthread_cond_broadcast(&c->cv_done);
        pthread_mutex_unlock(&c->mu);
        aw_free_job(j);
    }
}

void *cice_aw_start(int nthreads)
{
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 64) nthreads = 64;
    aw_ctx *c = (aw_ctx *)calloc(1, sizeof(aw_ctx));
    if (!c) return NULL;
    pthread_mutex_init(&c->mu, NULL);
    pthread_cond_init(&c->cv_push, NULL);
    pthread_cond_init(&c->cv_done, NULL);
    c->threads = (pthread_t *)calloc((size_t)nthreads, sizeof(pthread_t));
    if (!c->threads) { free(c); return NULL; }
    c->nthreads = nthreads;
    for (int i = 0; i < nthreads; i++) {
        if (pthread_create(&c->threads[i], NULL, aw_worker, c) != 0) {
            c->nthreads = i;
            break;
        }
    }
    if (c->nthreads == 0) {
        free(c->threads);
        free(c);
        return NULL;
    }
    return c;
}

int cice_aw_submit(void *h, const char *path, const void *data, size_t n,
                   const char *then_path, const char *then_text)
{
    aw_ctx *c = (aw_ctx *)h;
    if (!c || c->stop) return -1;
    aw_job *j = (aw_job *)calloc(1, sizeof(aw_job));
    if (!j) return -1;
    j->path = strdup(path);
    j->data = (const unsigned char *)data;
    j->n = n;
    j->ticket = -1;
    int want_then = then_path != NULL;
    if (want_then) {
        j->then_path = strdup(then_path);
        j->then_text = strdup(then_text ? then_text : "");
    }
    if (!j->path || (n && !data) ||
            (want_then && (!j->then_path || !j->then_text))) {
        aw_free_job(j);
        return -1;
    }

    pthread_mutex_lock(&c->mu);
    if (want_then) j->ticket = c->tickets++;
    if (c->tail) c->tail->next = j; else c->head = j;
    c->tail = j;
    c->queued++;
    pthread_cond_signal(&c->cv_push);
    pthread_mutex_unlock(&c->mu);
    return 0;
}

long cice_aw_flush(void *h)
{
    aw_ctx *c = (aw_ctx *)h;
    if (!c) return -1;
    pthread_mutex_lock(&c->mu);
    while (c->queued > 0 || c->inflight > 0)
        pthread_cond_wait(&c->cv_done, &c->mu);
    long errs = c->errors;
    pthread_mutex_unlock(&c->mu);
    return errs;
}

long cice_aw_pending(void *h)
{
    aw_ctx *c = (aw_ctx *)h;
    if (!c) return -1;
    pthread_mutex_lock(&c->mu);
    long n = c->queued + c->inflight;
    pthread_mutex_unlock(&c->mu);
    return n;
}

void cice_aw_stop(void *h)
{
    aw_ctx *c = (aw_ctx *)h;
    if (!c) return;
    cice_aw_flush(c);
    pthread_mutex_lock(&c->mu);
    c->stop = 1;
    pthread_cond_broadcast(&c->cv_push);
    pthread_mutex_unlock(&c->mu);
    for (int i = 0; i < c->nthreads; i++)
        pthread_join(c->threads[i], NULL);
    free(c->threads);
    pthread_mutex_destroy(&c->mu);
    pthread_cond_destroy(&c->cv_push);
    pthread_cond_destroy(&c->cv_done);
    free(c);
}
