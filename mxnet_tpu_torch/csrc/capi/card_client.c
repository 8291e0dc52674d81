/*
 * card_client: a pure-C client of libmxnet_tpu_torch that drives the
 * port's three hand-written kernels through the C ABI only.
 *
 *   card_client cpu|gpu IN_DIR OUT_DIR [dump]
 *
 * cpu binds with dev_type 1, gpu with dev_type 2 (cuda:0). IN_DIR holds
 * the inputs, written by the caller from a seed:
 *
 *   meta.txt         "resnet B H W C", "ssd B C H W",
 *                    "sgd LR MOMENTUM WD RESCALE_GRAD"
 *   resnet.json      a classifier ending in SoftmaxOutput (NHWC data)
 *   resnet_data.bin, resnet_label.bin, resnet_params.bin, resnet_aux.bin
 *                    float32: the arguments other than data and
 *                    softmax_label in list order, then the auxiliary states
 *   ssd-symbol.json, ssd-0000.params, ssd_data.bin
 *                    an SSD inference symbol, its dmlc parameter blob
 *
 * (a) MXSymbolCreateFromJSON, MXSymbolInferShape, MXExecutorBind, one
 *     training forward and backward, then one SGD-momentum update through
 *     MXKVStoreCreate("local") and a C updater (MXKVStoreSetUpdater) that
 *     calls sgd_mom_update in place with MXImperativeInvoke. Run with
 *     MXTPU_FUSE_CONV_BN=1, the executor's NHWC 1x1 Convolution->BatchNorm
 *     pairs run the matmul_stats kernel.
 * (b) MXPredCreate of the SSD from two C threads at once, each with its own
 *     predictor, one forward each: MultiBoxDetection's NMS kernel. The two
 *     threads' detections must be equal.
 * (c) MXRtcCreate of a CUDA SGD-momentum kernel and one MXRtcPush for each
 *     parameter array of (a), from the original weights, zero momentum and
 *     (a)'s gradients. With cpu arrays the push must fail.
 *
 * OUT_DIR/results.txt gets one line a result, "name count sum sum_abs"
 * (double sums in index order), and "CARD CLIENT PASS" is printed last;
 * with "dump", the arrays themselves are written beside it as float32
 * (a_grads.bin, a_params.bin, b_det.bin, c_w.bin, c_mom.bin).
 *
 * Compiled with -DCARD_CLIENT_NO_MAIN, the file has no main and exports
 * card_client_run(argc, argv) instead, for a process that already runs
 * Python (the library then finds its interpreter initialised).
 */
#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef uint64_t H;
typedef unsigned int mx_uint;

extern const char *MXGetLastError(void);
extern int MXNDArrayCreate(const uint32_t *, uint32_t, int, int, int, H *);
extern int MXNDArraySyncCopyFromCPU(H, const void *, size_t);
extern int MXNDArraySyncCopyToCPU(H, void *, size_t);
extern int MXNDArrayWaitAll(void);
extern int MXNDArrayFree(H);
extern int MXSymbolCreateFromJSON(const char *, H *);
extern int MXSymbolListArguments(H, uint32_t *, const char ***);
extern int MXSymbolListAuxiliaryStates(H, mx_uint *, const char ***);
extern int MXSymbolInferShape(H, mx_uint, const char **, const mx_uint *,
                              const mx_uint *, mx_uint *, const mx_uint **,
                              const mx_uint ***, mx_uint *, const mx_uint **,
                              const mx_uint ***, mx_uint *, const mx_uint **,
                              const mx_uint ***, int *);
extern int MXSymbolListAtomicSymbolCreators(mx_uint *, H **);
extern int MXSymbolGetAtomicSymbolName(H, const char **);
extern int MXSymbolFree(H);
extern int MXImperativeInvoke(H, int, H *, int *, H **, int, const char **,
                              const char **);
extern int MXExecutorBind(H, int, int, uint32_t, H *, H *, uint32_t, H *,
                          H *);
extern int MXExecutorForward(H, int);
extern int MXExecutorBackward(H, uint32_t, H *);
extern int MXExecutorOutputs(H, uint32_t *, H **);
extern int MXExecutorFree(H);
typedef void(MXKVStoreUpdater)(int, H, H, void *);
extern int MXKVStoreCreate(const char *, H *);
extern int MXKVStoreSetUpdater(H, MXKVStoreUpdater, void *);
extern int MXKVStoreInit(H, uint32_t, const int *, H *);
extern int MXKVStorePush(H, uint32_t, const int *, H *);
extern int MXKVStorePull(H, uint32_t, const int *, H *);
extern int MXKVStoreFree(H);
extern int MXPredCreate(const char *, const void *, int, int, int, uint32_t,
                        const char **, const uint32_t *, const uint32_t *,
                        H *);
extern int MXPredSetInput(H, const char *, const float *, uint32_t);
extern int MXPredForward(H);
extern int MXPredGetOutputShape(H, uint32_t, uint32_t **, uint32_t *);
extern int MXPredGetOutput(H, uint32_t, float *, uint32_t);
extern int MXPredFree(H);
extern int MXRtcCreate(char *, mx_uint, mx_uint, char **, char **, H *, H *,
                       char *, H *);
extern int MXRtcPush(H, mx_uint, mx_uint, H *, H *, mx_uint, mx_uint,
                     mx_uint, mx_uint, mx_uint, mx_uint);
extern int MXRtcFree(H);

#define CHK(call)                                                         \
    do {                                                                  \
        if ((call) != 0) {                                                \
            fprintf(stderr, "card_client: %s failed: %s\n", #call,        \
                    MXGetLastError());                                    \
            return -1;                                                    \
        }                                                                 \
    } while (0)

#define RTC_BLOCK 256

/* MXNet's SGD with momentum; hp = [lr, momentum, wd, rescale_grad, size]:
 * the size is data, so one kernel serves every array */
static char RTC_SGD[] =
    "int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
    "const int n = (int)hp[4];\n"
    "if (i < n) {\n"
    "  float m = hp[1] * mom[i] - hp[0] * (hp[3] * g[i] + hp[2] * w[i]);\n"
    "  mom[i] = m;\n"
    "  w[i] = w[i] + m;\n"
    "}";

typedef struct {
    int dev_type;
    const char *in_dir, *out_dir;
    int dump;
    FILE *results;
    unsigned rn_b, rn_h, rn_w, rn_c, ssd_b, ssd_c, ssd_h, ssd_w;
    float lr, momentum, wd, rescale;
} Run;

/* (a)'s arrays, which (c) reuses */
typedef struct {
    uint32_t nparam;
    char **names;
    size_t *sizes;
    uint32_t **shapes;
    uint32_t *ndims;
    H *weights, *grads;
    float *w0; /* the original weights, concatenated */
    size_t total;
} Params;

static char *path_of(const char *dir, const char *name) {
    size_t n = strlen(dir) + strlen(name) + 2;
    char *p = (char *)malloc(n);
    snprintf(p, n, "%s/%s", dir, name);
    return p;
}

/* the whole file; *size its length; NULL with a message on failure */
static char *read_file(const char *dir, const char *name, size_t *size) {
    char *p = path_of(dir, name);
    FILE *f = fopen(p, "rb");
    if (!f) {
        fprintf(stderr, "card_client: cannot open %s\n", p);
        free(p);
        return NULL;
    }
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    char *buf = (char *)malloc((size_t)n + 1);
    size_t got = fread(buf, 1, (size_t)n, f);
    fclose(f);
    free(p);
    if (got != (size_t)n) {
        free(buf);
        return NULL;
    }
    buf[n] = 0;
    if (size) *size = (size_t)n;
    return buf;
}

static int write_floats(Run *r, const char *name, const float *x, size_t n) {
    if (!r->dump) return 0;
    char *p = path_of(r->out_dir, name);
    FILE *f = fopen(p, "wb");
    free(p);
    if (!f || fwrite(x, sizeof(float), n, f) != n) {
        fprintf(stderr, "card_client: cannot write %s\n", name);
        if (f) fclose(f);
        return -1;
    }
    fclose(f);
    return 0;
}

static void checksum(Run *r, const char *name, const float *x, size_t n) {
    double s = 0, a = 0;
    for (size_t i = 0; i < n; i++) {
        s += x[i];
        a += fabs((double)x[i]);
    }
    fprintf(r->results, "%s %zu %.17g %.17g\n", name, n, s, a);
    fflush(r->results);
}

static int read_meta(Run *r) {
    char *p = path_of(r->in_dir, "meta.txt");
    FILE *f = fopen(p, "r");
    free(p);
    if (!f) return -1;
    int ok = fscanf(f, " resnet %u %u %u %u", &r->rn_b, &r->rn_h, &r->rn_w,
                    &r->rn_c) == 4 &&
             fscanf(f, " ssd %u %u %u %u", &r->ssd_b, &r->ssd_c, &r->ssd_h,
                    &r->ssd_w) == 4 &&
             fscanf(f, " sgd %f %f %f %f", &r->lr, &r->momentum, &r->wd,
                    &r->rescale) == 4;
    fclose(f);
    return ok ? 0 : -1;
}

/* ---------------- (a) bind, train step, kvstore update ---------------- */

static H g_sgd_mom = 0;          /* the sgd_mom_update creator */
static H *g_moms = NULL;         /* the updater's momentum, by key */
static char g_attr_vals[4][32];
static int g_updater_calls = 0, g_updater_failed = 0;

static int find_creator(const char *op, H *out) {
    mx_uint n = 0;
    H *creators = NULL;
    CHK(MXSymbolListAtomicSymbolCreators(&n, &creators));
    for (mx_uint i = 0; i < n; i++) {
        const char *name = NULL;
        CHK(MXSymbolGetAtomicSymbolName(creators[i], &name));
        if (strcmp(name, op) == 0) {
            *out = creators[i];
            return 0;
        }
    }
    fprintf(stderr, "card_client: no operator %s\n", op);
    return -1;
}

/* the KVStore's C updater: local <- sgd_mom_update(local, recv, mom) */
static void sgd_updater(int key, H recv, H local, void *closure) {
    (void)closure;
    static const char *keys[] = {"lr", "momentum", "wd", "rescale_grad"};
    const char *vals[] = {g_attr_vals[0], g_attr_vals[1], g_attr_vals[2],
                          g_attr_vals[3]};
    H ins[3] = {local, recv, g_moms[key]};
    H outs_buf[2] = {local, g_moms[key]};
    H *outs = outs_buf;
    int nout = 2;
    if (MXImperativeInvoke(g_sgd_mom, 3, ins, &nout, &outs, 4, keys,
                           vals) != 0) {
        fprintf(stderr, "card_client: updater key %d: %s\n", key,
                MXGetLastError());
        g_updater_failed++;
    }
    g_updater_calls++;
}

static int run_a(Run *r, Params *p) {
    size_t jn = 0;
    char *json = read_file(r->in_dir, "resnet.json", &jn);
    if (!json) return -1;
    H sym;
    CHK(MXSymbolCreateFromJSON(json, &sym));
    free(json);
    uint32_t narg = 0;
    const char **argn = NULL;
    CHK(MXSymbolListArguments(sym, &narg, &argn));
    char **args = (char **)calloc(narg, sizeof(char *));
    for (uint32_t i = 0; i < narg; i++) args[i] = strdup(argn[i]);
    mx_uint naux = 0;
    const char **auxn = NULL;
    CHK(MXSymbolListAuxiliaryStates(sym, &naux, &auxn));

    const char *keys[] = {"data", "softmax_label"};
    mx_uint indptr[] = {0, 4, 5};
    mx_uint shape_data[] = {r->rn_b, r->rn_h, r->rn_w, r->rn_c, r->rn_b};
    mx_uint in_size, out_size, aux_size;
    const mx_uint *in_ndim, *out_ndim, *aux_ndim;
    const mx_uint **in_data, **out_data, **aux_data;
    int complete = 0;
    CHK(MXSymbolInferShape(sym, 2, keys, indptr, shape_data, &in_size,
                           &in_ndim, &in_data, &out_size, &out_ndim,
                           &out_data, &aux_size, &aux_ndim, &aux_data,
                           &complete));
    if (!complete || in_size != narg || aux_size != naux || out_size != 1) {
        fprintf(stderr, "card_client: shape inference incomplete\n");
        return -1;
    }
    size_t data_n = 0, label_n = 0, params_n = 0, aux_bytes = 0;
    float *data = (float *)read_file(r->in_dir, "resnet_data.bin", &data_n);
    float *label = (float *)read_file(r->in_dir, "resnet_label.bin",
                                      &label_n);
    float *w0 = (float *)read_file(r->in_dir, "resnet_params.bin",
                                   &params_n);
    float *aux = (float *)read_file(r->in_dir, "resnet_aux.bin", &aux_bytes);
    if (!data || !label || !w0 || !aux) return -1;

    H *arg_h = (H *)calloc(narg, sizeof(H));
    H *grad_h = (H *)calloc(narg, sizeof(H));
    p->nparam = narg - 2;
    p->names = (char **)calloc(p->nparam, sizeof(char *));
    p->sizes = (size_t *)calloc(p->nparam, sizeof(size_t));
    p->shapes = (uint32_t **)calloc(p->nparam, sizeof(uint32_t *));
    p->ndims = (uint32_t *)calloc(p->nparam, sizeof(uint32_t));
    p->weights = (H *)calloc(p->nparam, sizeof(H));
    p->grads = (H *)calloc(p->nparam, sizeof(H));
    p->w0 = w0;
    size_t off = 0;
    uint32_t k = 0;
    for (uint32_t i = 0; i < narg; i++) {
        size_t n = 1;
        for (mx_uint d = 0; d < in_ndim[i]; d++) n *= in_data[i][d];
        CHK(MXNDArrayCreate(in_data[i], in_ndim[i], r->dev_type, 0, 0,
                            &arg_h[i]));
        if (!strcmp(args[i], "data")) {
            if (n * sizeof(float) != data_n) return -1;
            CHK(MXNDArraySyncCopyFromCPU(arg_h[i], data, n));
        } else if (!strcmp(args[i], "softmax_label")) {
            if (n * sizeof(float) != label_n) return -1;
            CHK(MXNDArraySyncCopyFromCPU(arg_h[i], label, n));
        } else {
            if ((off + n) * sizeof(float) > params_n) {
                fprintf(stderr, "card_client: resnet_params.bin is short\n");
                return -1;
            }
            CHK(MXNDArraySyncCopyFromCPU(arg_h[i], w0 + off, n));
            CHK(MXNDArrayCreate(in_data[i], in_ndim[i], r->dev_type, 0, 0,
                                &grad_h[i]));
            p->names[k] = args[i];
            p->sizes[k] = n;
            p->ndims[k] = in_ndim[i];
            p->shapes[k] = (uint32_t *)malloc(in_ndim[i] * sizeof(uint32_t));
            memcpy(p->shapes[k], in_data[i], in_ndim[i] * sizeof(uint32_t));
            p->weights[k] = arg_h[i];
            p->grads[k] = grad_h[i];
            off += n;
            k++;
        }
    }
    p->total = off;
    if (k != p->nparam || off * sizeof(float) != params_n) {
        fprintf(stderr, "card_client: resnet_params.bin holds %zu bytes, "
                "the arguments %zu\n", params_n, off * sizeof(float));
        return -1;
    }
    H *aux_h = (H *)calloc(naux ? naux : 1, sizeof(H));
    size_t aoff = 0;
    for (mx_uint i = 0; i < naux; i++) {
        size_t n = 1;
        for (mx_uint d = 0; d < aux_ndim[i]; d++) n *= aux_data[i][d];
        CHK(MXNDArrayCreate(aux_data[i], aux_ndim[i], r->dev_type, 0, 0,
                            &aux_h[i]));
        if ((aoff + n) * sizeof(float) > aux_bytes) return -1;
        CHK(MXNDArraySyncCopyFromCPU(aux_h[i], aux + aoff, n));
        aoff += n;
    }
    free(data);
    free(label);
    free(aux);

    H exec;
    CHK(MXExecutorBind(sym, r->dev_type, 0, narg, arg_h, grad_h, naux, aux_h,
                       &exec));
    CHK(MXExecutorForward(exec, 1));
    CHK(MXExecutorBackward(exec, 0, NULL));
    uint32_t nout = 0;
    H *outs = NULL;
    CHK(MXExecutorOutputs(exec, &nout, &outs));
    H prob_h = outs[0];
    size_t classes = out_data[0][1];
    float *prob = (float *)malloc(r->rn_b * classes * sizeof(float));
    float *lab = (float *)malloc(r->rn_b * sizeof(float));
    CHK(MXNDArraySyncCopyToCPU(prob_h, prob, r->rn_b * classes));
    for (uint32_t i = 0; i < narg; i++)
        if (!strcmp(args[i], "softmax_label"))
            CHK(MXNDArraySyncCopyToCPU(arg_h[i], lab, r->rn_b));
    double loss = 0;
    for (unsigned b = 0; b < r->rn_b; b++)
        loss -= log(fmax((double)prob[b * classes + (size_t)lab[b]], 1e-30));
    loss /= r->rn_b;
    fprintf(r->results, "a_loss 1 %.17g %.17g\n", loss, fabs(loss));
    checksum(r, "a_prob", prob, r->rn_b * classes);
    free(prob);
    free(lab);

    float *host = (float *)malloc(p->total * sizeof(float));
    off = 0;
    for (uint32_t i = 0; i < p->nparam; i++) {
        CHK(MXNDArraySyncCopyToCPU(p->grads[i], host + off, p->sizes[i]));
        off += p->sizes[i];
    }
    checksum(r, "a_grads", host, p->total);
    if (write_floats(r, "a_grads.bin", host, p->total)) return -1;

    /* the update: a local KVStore whose C updater runs sgd_mom_update */
    CHK(find_creator("sgd_mom_update", &g_sgd_mom));
    snprintf(g_attr_vals[0], 32, "%.9g", r->lr);
    snprintf(g_attr_vals[1], 32, "%.9g", r->momentum);
    snprintf(g_attr_vals[2], 32, "%.9g", r->wd);
    snprintf(g_attr_vals[3], 32, "%.9g", r->rescale);
    g_moms = (H *)calloc(p->nparam, sizeof(H));
    int *kv_keys = (int *)calloc(p->nparam, sizeof(int));
    for (uint32_t i = 0; i < p->nparam; i++) {
        CHK(MXNDArrayCreate(p->shapes[i], p->ndims[i], r->dev_type, 0, 0,
                            &g_moms[i]));
        kv_keys[i] = (int)i;
    }
    H kv;
    CHK(MXKVStoreCreate("local", &kv));
    CHK(MXKVStoreSetUpdater(kv, sgd_updater, NULL));
    CHK(MXKVStoreInit(kv, p->nparam, kv_keys, p->weights));
    CHK(MXKVStorePush(kv, p->nparam, kv_keys, p->grads));
    CHK(MXKVStorePull(kv, p->nparam, kv_keys, p->weights));
    CHK(MXNDArrayWaitAll());
    if (g_updater_failed || g_updater_calls != (int)p->nparam) {
        fprintf(stderr, "card_client: updater ran %d times (%d failed) for "
                "%u keys\n", g_updater_calls, g_updater_failed, p->nparam);
        return -1;
    }
    off = 0;
    for (uint32_t i = 0; i < p->nparam; i++) {
        CHK(MXNDArraySyncCopyToCPU(p->weights[i], host + off, p->sizes[i]));
        off += p->sizes[i];
    }
    checksum(r, "a_params", host, p->total);
    if (write_floats(r, "a_params.bin", host, p->total)) return -1;
    free(host);
    printf("card_client (a): %u arguments, %u auxiliary states, loss %.6f, "
           "%d updater calls\n", narg, naux, loss, g_updater_calls);
    CHK(MXKVStoreFree(kv));
    CHK(MXExecutorFree(exec));
    CHK(MXSymbolFree(sym));
    free(kv_keys);
    return 0;
}

/* ---------------- (b) the SSD predictor from two threads ---------------- */

typedef struct {
    Run *r;
    const char *json;
    const char *params;
    size_t params_n;
    const float *data;
    float *det;
    size_t det_n;
    int failed;
} PredJob;

#define TCHK(call)                                                        \
    do {                                                                  \
        if ((call) != 0) {                                                \
            fprintf(stderr, "card_client: thread: %s failed: %s\n",       \
                    #call, MXGetLastError());                             \
            job->failed = 1;                                              \
            return NULL;                                                  \
        }                                                                 \
    } while (0)

static void *pred_thread(void *arg) {
    PredJob *job = (PredJob *)arg;
    Run *r = job->r;
    const char *keys[] = {"data"};
    uint32_t indptr[] = {0, 4};
    uint32_t shape[] = {r->ssd_b, r->ssd_c, r->ssd_h, r->ssd_w};
    H pred;
    TCHK(MXPredCreate(job->json, job->params, (int)job->params_n,
                      r->dev_type, 0, 1, keys, indptr, shape, &pred));
    TCHK(MXPredSetInput(pred, "data", job->data,
                        r->ssd_b * r->ssd_c * r->ssd_h * r->ssd_w));
    TCHK(MXPredForward(pred));
    uint32_t *oshape = NULL, ondim = 0;
    TCHK(MXPredGetOutputShape(pred, 0, &oshape, &ondim));
    size_t n = 1;
    for (uint32_t d = 0; d < ondim; d++) n *= oshape[d];
    job->det = (float *)malloc(n * sizeof(float));
    job->det_n = n;
    TCHK(MXPredGetOutput(pred, 0, job->det, (uint32_t)n));
    TCHK(MXPredFree(pred));
    return NULL;
}

static int run_b(Run *r) {
    size_t jn = 0, pn = 0, dn = 0;
    char *json = read_file(r->in_dir, "ssd-symbol.json", &jn);
    char *params = read_file(r->in_dir, "ssd-0000.params", &pn);
    float *data = (float *)read_file(r->in_dir, "ssd_data.bin", &dn);
    if (!json || !params || !data) return -1;
    if (dn != (size_t)r->ssd_b * r->ssd_c * r->ssd_h * r->ssd_w * 4) {
        fprintf(stderr, "card_client: ssd_data.bin has %zu bytes\n", dn);
        return -1;
    }
    PredJob jobs[2];
    pthread_t th[2];
    for (int t = 0; t < 2; t++) {
        memset(&jobs[t], 0, sizeof(PredJob));
        jobs[t].r = r;
        jobs[t].json = json;
        jobs[t].params = params;
        jobs[t].params_n = pn;
        jobs[t].data = data;
        pthread_create(&th[t], NULL, pred_thread, &jobs[t]);
    }
    for (int t = 0; t < 2; t++) pthread_join(th[t], NULL);
    if (jobs[0].failed || jobs[1].failed) return -1;
    if (jobs[0].det_n != jobs[1].det_n ||
        memcmp(jobs[0].det, jobs[1].det, jobs[0].det_n * sizeof(float))) {
        fprintf(stderr, "card_client: the two threads' detections differ\n");
        return -1;
    }
    size_t kept = 0;
    for (size_t i = 0; i < jobs[0].det_n; i += 6)
        if (jobs[0].det[i] >= 0) kept++;
    checksum(r, "b_det", jobs[0].det, jobs[0].det_n);
    if (write_floats(r, "b_det.bin", jobs[0].det, jobs[0].det_n)) return -1;
    printf("card_client (b): two threads, detections equal, %zu values, "
           "%zu rows kept\n", jobs[0].det_n, kept);
    for (int t = 0; t < 2; t++) free(jobs[t].det);
    free(json);
    free(params);
    free(data);
    return 0;
}

/* ---------------- (c) the SGD update as an Rtc kernel ---------------- */

static int run_c(Run *r, Params *p) {
    H *w = (H *)calloc(p->nparam, sizeof(H));
    H *mom = (H *)calloc(p->nparam, sizeof(H));
    H *hp = (H *)calloc(p->nparam, sizeof(H));
    size_t off = 0;
    for (uint32_t i = 0; i < p->nparam; i++) {
        uint32_t five = 5;
        float h[5] = {r->lr, r->momentum, r->wd, r->rescale,
                      (float)p->sizes[i]};
        CHK(MXNDArrayCreate(p->shapes[i], p->ndims[i], r->dev_type, 0, 0,
                            &w[i]));
        CHK(MXNDArraySyncCopyFromCPU(w[i], p->w0 + off, p->sizes[i]));
        CHK(MXNDArrayCreate(p->shapes[i], p->ndims[i], r->dev_type, 0, 0,
                            &mom[i]));
        CHK(MXNDArrayCreate(&five, 1, r->dev_type, 0, 0, &hp[i]));
        CHK(MXNDArraySyncCopyFromCPU(hp[i], h, 5));
        off += p->sizes[i];
    }
    char *in_names[] = {"g", "hp"}, *out_names[] = {"w", "mom"};
    H ins[2] = {p->grads[0], hp[0]}, outs[2] = {w[0], mom[0]};
    H rtc;
    CHK(MXRtcCreate("sgd_mom", 2, 2, in_names, out_names, ins, outs, RTC_SGD,
                    &rtc));
    if (r->dev_type == 1) {
        /* a CPU array cannot be launched on */
        if (MXRtcPush(rtc, 2, 2, ins, outs, 1, 1, 1, RTC_BLOCK, 1, 1) == 0) {
            fprintf(stderr, "card_client: MXRtcPush on cpu arrays did not "
                    "fail\n");
            return -1;
        }
        printf("card_client (c): MXRtcPush on cpu arrays fails: %.120s\n",
               MXGetLastError());
        CHK(MXRtcFree(rtc));
        return 0;
    }
    for (uint32_t i = 0; i < p->nparam; i++) {
        H pi[2] = {p->grads[i], hp[i]}, po[2] = {w[i], mom[i]};
        mx_uint grid = (mx_uint)((p->sizes[i] + RTC_BLOCK - 1) / RTC_BLOCK);
        CHK(MXRtcPush(rtc, 2, 2, pi, po, grid, 1, 1, RTC_BLOCK, 1, 1));
    }
    CHK(MXNDArrayWaitAll());
    float *host = (float *)malloc(p->total * sizeof(float));
    const char *what[2] = {"c_w", "c_mom"};
    H *arrays[2] = {w, mom};
    for (int a = 0; a < 2; a++) {
        off = 0;
        for (uint32_t i = 0; i < p->nparam; i++) {
            CHK(MXNDArraySyncCopyToCPU(arrays[a][i], host + off,
                                       p->sizes[i]));
            off += p->sizes[i];
        }
        checksum(r, what[a], host, p->total);
        char name[16];
        snprintf(name, sizeof(name), "%s.bin", what[a]);
        if (write_floats(r, name, host, p->total)) return -1;
    }
    free(host);
    printf("card_client (c): %u pushes of one Rtc kernel\n", p->nparam);
    CHK(MXRtcFree(rtc));
    return 0;
}

int card_client_run(int argc, char **argv) {
    if (argc < 4 || (strcmp(argv[1], "cpu") && strcmp(argv[1], "gpu"))) {
        fprintf(stderr, "usage: card_client cpu|gpu IN_DIR OUT_DIR [dump]\n");
        return 2;
    }
    Run r;
    memset(&r, 0, sizeof(r));
    r.dev_type = strcmp(argv[1], "gpu") ? 1 : 2;
    r.in_dir = argv[2];
    r.out_dir = argv[3];
    r.dump = argc > 4 && !strcmp(argv[4], "dump");
    if (read_meta(&r)) {
        fprintf(stderr, "card_client: cannot read %s/meta.txt\n", r.in_dir);
        return 1;
    }
    char *rp = path_of(r.out_dir, "results.txt");
    r.results = fopen(rp, "w");
    free(rp);
    if (!r.results) return 1;
    Params p;
    memset(&p, 0, sizeof(p));
    int rc = run_a(&r, &p) || run_b(&r) || run_c(&r, &p);
    fclose(r.results);
    g_updater_calls = g_updater_failed = 0;
    if (rc) return 1;
    printf("CARD CLIENT PASS (%s)\n", argv[1]);
    fflush(stdout);
    return 0;
}

#ifndef CARD_CLIENT_NO_MAIN
int main(int argc, char **argv) { return card_client_run(argc, argv); }
#endif
