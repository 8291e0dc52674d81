/*
 * libmxnet_tpu_torch: the compiled C API of mxnet_tpu_torch.
 *
 * The port's own copy of src/capi/libmxnet_tpu.c, which it follows
 * function for function: the reference's binding contract (ref:
 * include/mxnet/c_api.h, src/c_api/*.cc: opaque handles, int status
 * returns, MXGetLastError) as `extern "C"` symbols that a client in any
 * language links. Each entry point marshals into mxnet_tpu_torch.c_api
 * through the embedded CPython interpreter; handles are the Python side's
 * integer registry keys. Devices pass through as given (dev_type 1 is the
 * CPU, 2 is cuda:<dev_id>).
 *
 * Build: python -m mxnet_tpu_torch.capi_build (prints the library's path;
 * links libpython through python3-config --ldflags --embed).
 * Client: mxnet_tpu_torch/csrc/capi/card_client.c.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

typedef uint64_t NDArrayHandle;
typedef uint64_t SymbolHandle;
typedef uint64_t ExecutorHandle;
typedef uint64_t KVStoreHandle;

#define MXTPU_EXPORT __attribute__((visibility("default")))

static PyObject *g_capi = NULL;          /* mxnet_tpu_torch.c_api module */
static __thread char g_err[4096];
static __thread char g_shape_buf[32 * sizeof(uint32_t)];

static void set_err(const char *msg) {
    strncpy(g_err, msg ? msg : "unknown error", sizeof(g_err) - 1);
    g_err[sizeof(g_err) - 1] = 0;
}

static void set_err_from_py(void) {
    PyObject *t, *v, *tb;
    PyErr_Fetch(&t, &v, &tb);
    if (v) {
        PyObject *s = PyObject_Str(v);
        set_err(s ? PyUnicode_AsUTF8(s) : "python error");
        Py_XDECREF(s);
    } else {
        set_err("python error (no message)");
    }
    Py_XDECREF(t); Py_XDECREF(v); Py_XDECREF(tb);
}

/* Initialize the interpreter + import mxnet_tpu_torch.c_api once.
 * Mutex-guarded: concurrent first calls from multiple client threads must
 * not double-run Py_InitializeEx/PyEval_SaveThread. */
#include <dlfcn.h>
#include <pthread.h>
static pthread_mutex_t g_init_lock = PTHREAD_MUTEX_INITIALIZER;

#define MXTPU_STR2(x) #x
#define MXTPU_STR(x) MXTPU_STR2(x)

static int ensure_init(void) {
    if (g_capi) return 0;
    pthread_mutex_lock(&g_init_lock);
    if (g_capi) {
        pthread_mutex_unlock(&g_init_lock);
        return 0;
    }
    if (!Py_IsInitialized()) {
        /* when THIS library was dlopen'd by a foreign host (Perl, R, Lua),
         * libpython's symbols are not in the global namespace and python's
         * own extension modules (math, _struct, numpy) fail to resolve
         * them — promote libpython to RTLD_GLOBAL first */
        const char *pylibs[] = {
            "libpython" MXTPU_STR(PY_MAJOR_VERSION) "."
                MXTPU_STR(PY_MINOR_VERSION) ".so.1.0",
            "libpython" MXTPU_STR(PY_MAJOR_VERSION) "."
                MXTPU_STR(PY_MINOR_VERSION) ".so",
            NULL};
        for (int i = 0; pylibs[i]; i++)
            if (dlopen(pylibs[i], RTLD_NOW | RTLD_GLOBAL)) break;
        Py_InitializeEx(0);
        /* release the GIL so PyGILState_Ensure works from any thread */
        PyEval_SaveThread();
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *m = PyImport_ImportModule("mxnet_tpu_torch.c_api");
    if (!m) {
        set_err_from_py();
        PyGILState_Release(st);
        pthread_mutex_unlock(&g_init_lock);
        return -1;
    }
    g_capi = m;                           /* keep the reference forever */
    PyGILState_Release(st);
    pthread_mutex_unlock(&g_init_lock);
    return 0;
}

/* Call c_api.<name>(*args); unpack the (status, value) tuple.
 * Returns new ref to value or NULL (error stored). */
static PyObject *capi_call(const char *name, PyObject *args) {
    PyObject *fn = PyObject_GetAttrString(g_capi, name);
    if (!fn) { set_err_from_py(); Py_XDECREF(args); return NULL; }
    PyObject *res = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    Py_XDECREF(args);
    if (!res) { set_err_from_py(); return NULL; }
    if (!PyTuple_Check(res) || PyTuple_Size(res) != 2) {
        set_err("c_api returned malformed result");
        Py_DECREF(res);
        return NULL;
    }
    long status = PyLong_AsLong(PyTuple_GetItem(res, 0));
    if (status != 0) {
        PyObject *le = PyObject_CallMethod(g_capi, "MXGetLastError", NULL);
        if (le) {
            PyObject *msg = PyTuple_Check(le) && PyTuple_Size(le) == 2
                                ? PyTuple_GetItem(le, 1) : le;
            if (msg && PyUnicode_Check(msg)) set_err(PyUnicode_AsUTF8(msg));
            else set_err("c_api call failed");
            Py_DECREF(le);
        } else {
            PyErr_Clear();
            set_err("c_api call failed");
        }
        Py_DECREF(res);
        return NULL;
    }
    PyObject *val = PyTuple_GetItem(res, 1);
    Py_INCREF(val);
    Py_DECREF(res);
    return val;
}

#define ENSURE() do { if (ensure_init()) return -1; } while (0)

MXTPU_EXPORT const char *MXGetLastError(void) { return g_err; }

MXTPU_EXPORT int MXGetVersion(int *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXGetVersion", PyTuple_New(0));
    int rc = -1;
    if (v) { *out = (int)PyLong_AsLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNotifyShutdown(void) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNotifyShutdown", PyTuple_New(0));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

/* ---------------- NDArray ---------------- */

MXTPU_EXPORT int MXNDArrayCreate(const uint32_t *shape, uint32_t ndim,
                                 int dev_type, int dev_id, int delay_alloc,
                                 NDArrayHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pshape = PyTuple_New(ndim);
    for (uint32_t i = 0; i < ndim; i++)
        PyTuple_SetItem(pshape, i, PyLong_FromUnsignedLong(shape[i]));
    PyObject *v = capi_call("MXNDArrayCreate",
                            Py_BuildValue("(Niii)", pshape, dev_type,
                                          dev_id, delay_alloc));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArrayFree(NDArrayHandle h) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNDArrayFree", Py_BuildValue("(K)", h));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArraySyncCopyFromCPU(NDArrayHandle h, const void *data,
                                          size_t size) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *buf = PyBytes_FromStringAndSize((const char *)data,
                                              size * sizeof(float));
    PyObject *v = capi_call("MXNDArraySyncCopyFromBytes",
                            Py_BuildValue("(KN)", h, buf));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArraySyncCopyToCPU(NDArrayHandle h, void *data,
                                        size_t size) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNDArraySyncCopyToBytes",
                            Py_BuildValue("(K)", h));
    int rc = -1;
    if (v) {
        size_t n = (size_t)PyBytes_Size(v);
        size_t want = size * sizeof(float);
        if (n != want) {
            /* reference contract (CHECK_EQ(size, arr.Size())): a size
             * mismatch is an error, never a silent truncation */
            char msg[128];
            snprintf(msg, sizeof(msg),
                     "MXNDArraySyncCopyToCPU: caller size %zu bytes does "
                     "not match array size %zu bytes", want, n);
            set_err(msg);
        } else {
            memcpy(data, PyBytes_AsString(v), want);
            rc = 0;
        }
        Py_DECREF(v);
    }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArrayGetShape(NDArrayHandle h, uint32_t *out_dim,
                                   const uint32_t **out_pdata) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNDArrayGetShape", Py_BuildValue("(K)", h));
    int rc = -1;
    if (v) {
        uint32_t n = (uint32_t)PySequence_Size(v);
        if (n > 32) {
            /* never hand out a buffer holding fewer dims than ndim claims */
            char msg[96];
            snprintf(msg, sizeof(msg),
                     "MXNDArrayGetShape: ndim %u exceeds the 32-dim "
                     "shape buffer", n);
            set_err(msg);
        } else {
            uint32_t *buf = (uint32_t *)g_shape_buf;
            for (uint32_t i = 0; i < n; i++) {
                PyObject *it = PySequence_GetItem(v, i);
                buf[i] = (uint32_t)PyLong_AsUnsignedLong(it);
                Py_DECREF(it);
            }
            *out_dim = n;
            *out_pdata = buf;
            rc = 0;
        }
        Py_DECREF(v);
    }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArrayWaitAll(void) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNDArrayWaitAll", PyTuple_New(0));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

/* ---------------- Symbol ---------------- */

MXTPU_EXPORT int MXSymbolCreateVariable(const char *name, SymbolHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXSymbolCreateVariable",
                            Py_BuildValue("(s)", name));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXSymbolCreateAtomicSymbol(const char *op_name,
                                            uint32_t num_param,
                                            const char **keys,
                                            const char **vals,
                                            SymbolHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pk = PyList_New(num_param), *pv = PyList_New(num_param);
    for (uint32_t i = 0; i < num_param; i++) {
        PyList_SetItem(pk, i, PyUnicode_FromString(keys[i]));
        PyList_SetItem(pv, i, PyUnicode_FromString(vals[i]));
    }
    PyObject *v = capi_call("MXSymbolCreateAtomicSymbol",
                            Py_BuildValue("(sNN)", op_name, pk, pv));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXSymbolCompose(SymbolHandle sym, const char *name,
                                 uint32_t num_args, const char **keys,
                                 SymbolHandle *args) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pa = PyList_New(num_args);
    for (uint32_t i = 0; i < num_args; i++)
        PyList_SetItem(pa, i, PyLong_FromUnsignedLongLong(args[i]));
    PyObject *pk;
    if (keys) {
        pk = PyList_New(num_args);
        for (uint32_t i = 0; i < num_args; i++)
            PyList_SetItem(pk, i, PyUnicode_FromString(keys[i]));
    } else {
        pk = Py_None;
        Py_INCREF(Py_None);
    }
    PyObject *v = capi_call("MXSymbolCompose",
                            Py_BuildValue("(KsNN)", sym, name, pa, pk));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXSymbolSaveToJSON(SymbolHandle sym, const char **out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    static __thread char *json_buf = NULL;
    PyObject *v = capi_call("MXSymbolSaveToJSON", Py_BuildValue("(K)", sym));
    int rc = -1;
    if (v) {
        const char *s = PyUnicode_AsUTF8(v);
        free(json_buf);
        json_buf = strdup(s ? s : "");
        *out = json_buf;
        Py_DECREF(v);
        rc = 0;
    }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXSymbolCreateFromJSON(const char *json, SymbolHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXSymbolCreateFromJSON",
                            Py_BuildValue("(s)", json));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

/* list arguments: returns count; names via repeated calls (thread buffer) */
MXTPU_EXPORT int MXSymbolListArguments(SymbolHandle sym, uint32_t *out_size,
                                       const char ***out_array) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    static __thread char **name_buf = NULL;
    static __thread uint32_t name_cnt = 0;
    PyObject *v = capi_call("MXSymbolListArguments",
                            Py_BuildValue("(K)", sym));
    int rc = -1;
    if (v) {
        for (uint32_t i = 0; i < name_cnt; i++) free(name_buf[i]);
        free(name_buf);
        name_cnt = (uint32_t)PySequence_Size(v);
        name_buf = (char **)calloc(name_cnt, sizeof(char *));
        for (uint32_t i = 0; i < name_cnt; i++) {
            PyObject *it = PySequence_GetItem(v, i);
            name_buf[i] = strdup(PyUnicode_AsUTF8(it));
            Py_DECREF(it);
        }
        *out_size = name_cnt;
        *out_array = (const char **)name_buf;
        Py_DECREF(v);
        rc = 0;
    }
    PyGILState_Release(st);
    return rc;
}

/* ---------------- Executor ---------------- */

MXTPU_EXPORT int MXExecutorBind(SymbolHandle sym, int dev_type, int dev_id,
                                uint32_t num_args, NDArrayHandle *in_args,
                                NDArrayHandle *arg_grads,
                                uint32_t num_aux, NDArrayHandle *aux_states,
                                ExecutorHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pargs = PyList_New(num_args);
    for (uint32_t i = 0; i < num_args; i++)
        PyList_SetItem(pargs, i, PyLong_FromUnsignedLongLong(in_args[i]));
    PyObject *pgrads;
    if (arg_grads) {
        pgrads = PyList_New(num_args);
        for (uint32_t i = 0; i < num_args; i++)
            PyList_SetItem(pgrads, i,
                           PyLong_FromUnsignedLongLong(arg_grads[i]));
    } else {
        pgrads = Py_None;
        Py_INCREF(Py_None);
    }
    PyObject *paux;
    if (num_aux) {
        paux = PyList_New(num_aux);
        for (uint32_t i = 0; i < num_aux; i++)
            PyList_SetItem(paux, i,
                           PyLong_FromUnsignedLongLong(aux_states[i]));
    } else {
        paux = Py_None;
        Py_INCREF(Py_None);
    }
    PyObject *v = capi_call("MXExecutorBind",
                            Py_BuildValue("(KiiNNsN)", sym, dev_type, dev_id,
                                          pargs, pgrads, "write", paux));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXExecutorForward(ExecutorHandle h, int is_train) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXExecutorForward",
                            Py_BuildValue("(Ki)", h, is_train));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXExecutorBackward(ExecutorHandle h, uint32_t len,
                                    NDArrayHandle *head_grads) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pg;
    if (len && head_grads) {
        pg = PyList_New(len);
        for (uint32_t i = 0; i < len; i++)
            PyList_SetItem(pg, i, PyLong_FromUnsignedLongLong(head_grads[i]));
    } else {
        pg = Py_None;
        Py_INCREF(Py_None);
    }
    PyObject *v = capi_call("MXExecutorBackward",
                            Py_BuildValue("(KN)", h, pg));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXExecutorOutputs(ExecutorHandle h, uint32_t *out_size,
                                   NDArrayHandle **out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    static __thread NDArrayHandle *out_buf = NULL;
    PyObject *v = capi_call("MXExecutorOutputs", Py_BuildValue("(K)", h));
    int rc = -1;
    if (v) {
        uint32_t n = (uint32_t)PySequence_Size(v);
        free(out_buf);
        out_buf = (NDArrayHandle *)calloc(n, sizeof(NDArrayHandle));
        for (uint32_t i = 0; i < n; i++) {
            PyObject *it = PySequence_GetItem(v, i);
            out_buf[i] = PyLong_AsUnsignedLongLong(it);
            Py_DECREF(it);
        }
        *out_size = n;
        *out = out_buf;
        Py_DECREF(v);
        rc = 0;
    }
    PyGILState_Release(st);
    return rc;
}

/* ---------------- KVStore ---------------- */

MXTPU_EXPORT int MXKVStoreCreate(const char *type, KVStoreHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXKVStoreCreate", Py_BuildValue("(s)", type));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

static int kv_keyvals(const char *fname, KVStoreHandle h, uint32_t num,
                      const int *keys, NDArrayHandle *vals) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pk = PyList_New(num), *pv = PyList_New(num);
    for (uint32_t i = 0; i < num; i++) {
        PyList_SetItem(pk, i, PyLong_FromLong(keys[i]));
        PyList_SetItem(pv, i, PyLong_FromUnsignedLongLong(vals[i]));
    }
    PyObject *v = capi_call(fname, Py_BuildValue("(KNN)", h, pk, pv));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXKVStoreInit(KVStoreHandle h, uint32_t num,
                               const int *keys, NDArrayHandle *vals) {
    ENSURE();
    return kv_keyvals("MXKVStoreInit", h, num, keys, vals);
}

MXTPU_EXPORT int MXKVStorePush(KVStoreHandle h, uint32_t num,
                               const int *keys, NDArrayHandle *vals) {
    ENSURE();
    return kv_keyvals("MXKVStorePush", h, num, keys, vals);
}

MXTPU_EXPORT int MXKVStorePull(KVStoreHandle h, uint32_t num,
                               const int *keys, NDArrayHandle *vals) {
    ENSURE();
    return kv_keyvals("MXKVStorePull", h, num, keys, vals);
}

/* ---------------- C predict API (ref: c_predict_api.h) ---------------- */

typedef uint64_t PredictorHandle;

MXTPU_EXPORT int MXPredCreate(const char *symbol_json,
                              const void *param_bytes, int param_size,
                              int dev_type, int dev_id,
                              uint32_t num_input_nodes,
                              const char **input_keys,
                              const uint32_t *input_shape_indptr,
                              const uint32_t *input_shape_data,
                              PredictorHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pk = PyList_New(num_input_nodes);
    PyObject *ps = PyList_New(num_input_nodes);
    for (uint32_t i = 0; i < num_input_nodes; i++) {
        PyList_SetItem(pk, i, PyUnicode_FromString(input_keys[i]));
        uint32_t b = input_shape_indptr[i], e = input_shape_indptr[i + 1];
        PyObject *shape = PyTuple_New(e - b);
        for (uint32_t j = b; j < e; j++)
            PyTuple_SetItem(shape, j - b,
                            PyLong_FromUnsignedLong(input_shape_data[j]));
        PyList_SetItem(ps, i, shape);
    }
    PyObject *pb = PyBytes_FromStringAndSize(
        (const char *)param_bytes, param_size);
    PyObject *v = capi_call("MXPredCreate",
                            Py_BuildValue("(sNiiNN)", symbol_json, pb,
                                          dev_type, dev_id, pk, ps));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

/* CSR key/shape marshalling shared by the MXPred* entry points: fills
 * *out_keys / *out_shapes with new refs (call under the GIL) */
static void pred_keys_shapes(uint32_t n, const char **keys,
                             const uint32_t *indptr, const uint32_t *data,
                             PyObject **out_keys, PyObject **out_shapes) {
    PyObject *pk = PyList_New(n), *ps = PyList_New(n);
    for (uint32_t i = 0; i < n; i++) {
        PyList_SetItem(pk, i, PyUnicode_FromString(keys[i]));
        uint32_t b = indptr[i], e = indptr[i + 1];
        PyObject *shape = PyTuple_New(e - b);
        for (uint32_t j = b; j < e; j++)
            PyTuple_SetItem(shape, j - b, PyLong_FromUnsignedLong(data[j]));
        PyList_SetItem(ps, i, shape);
    }
    *out_keys = pk;
    *out_shapes = ps;
}

MXTPU_EXPORT int MXPredCreatePartialOut(
    const char *symbol_json, const void *param_bytes, int param_size,
    int dev_type, int dev_id, uint32_t num_input_nodes,
    const char **input_keys, const uint32_t *input_shape_indptr,
    const uint32_t *input_shape_data, uint32_t num_output_nodes,
    const char **output_keys, PredictorHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pk, *ps;
    pred_keys_shapes(num_input_nodes, input_keys, input_shape_indptr,
                     input_shape_data, &pk, &ps);
    PyObject *po = PyList_New(num_output_nodes);
    for (uint32_t i = 0; i < num_output_nodes; i++)
        PyList_SetItem(po, i, PyUnicode_FromString(output_keys[i]));
    PyObject *pb = PyBytes_FromStringAndSize(
        (const char *)param_bytes, param_size);
    PyObject *v = capi_call("MXPredCreatePartialOut",
                            Py_BuildValue("(sNiiNNN)", symbol_json, pb,
                                          dev_type, dev_id, pk, ps, po));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXPredReshape(uint32_t num_input_nodes,
                               const char **input_keys,
                               const uint32_t *input_shape_indptr,
                               const uint32_t *input_shape_data,
                               PredictorHandle handle,
                               PredictorHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pk, *ps;
    pred_keys_shapes(num_input_nodes, input_keys, input_shape_indptr,
                     input_shape_data, &pk, &ps);
    PyObject *v = capi_call("MXPredReshape",
                            Py_BuildValue("(KNN)", handle, pk, ps));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXPredSetInput(PredictorHandle h, const char *key,
                                const float *data, uint32_t size) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *buf = PyBytes_FromStringAndSize((const char *)data,
                                              (Py_ssize_t)size * 4);
    PyObject *v = capi_call("MXPredSetInput",
                            Py_BuildValue("(KsN)", h, key, buf));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXPredForward(PredictorHandle h) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXPredForward", Py_BuildValue("(K)", h));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXPredGetOutputShape(PredictorHandle h, uint32_t index,
                                      uint32_t **shape_data,
                                      uint32_t *shape_ndim) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXPredGetOutputShape",
                            Py_BuildValue("(KI)", h, index));
    int rc = -1;
    if (v) {
        uint32_t n = (uint32_t)PySequence_Size(v);
        if (n > 32) {
            char msg[96];
            snprintf(msg, sizeof(msg),
                     "MXPredGetOutputShape: ndim %u exceeds the 32-dim "
                     "shape buffer", n);
            set_err(msg);
        } else {
            uint32_t *buf = (uint32_t *)g_shape_buf;
            for (uint32_t i = 0; i < n; i++) {
                PyObject *it = PySequence_GetItem(v, i);
                buf[i] = (uint32_t)PyLong_AsUnsignedLong(it);
                Py_DECREF(it);
            }
            *shape_data = buf;
            *shape_ndim = n;
            rc = 0;
        }
        Py_DECREF(v);
    }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXPredGetOutput(PredictorHandle h, uint32_t index,
                                 float *data, uint32_t size) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXPredGetOutput", Py_BuildValue("(KI)", h,
                                                             index));
    int rc = -1;
    if (v) {
        size_t n = (size_t)PyBytes_Size(v);
        size_t want = (size_t)size * 4;
        if (n != want) {
            char msg[128];
            snprintf(msg, sizeof(msg),
                     "MXPredGetOutput: caller size %zu bytes does not "
                     "match output size %zu bytes", want, n);
            set_err(msg);
        } else {
            memcpy(data, PyBytes_AsString(v), want);
            rc = 0;
        }
        Py_DECREF(v);
    }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXPredFree(PredictorHandle h) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXPredFree", Py_BuildValue("(K)", h));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

/* ======================================================================
 * r5: remaining c_api.h families — DataIter, autograd, RecordIO, Rtc,
 * profiler, Func registry, op introspection, symbol/executor/kvstore
 * completion (ref: include/mxnet/c_api.h; impls src/c_api/c_api*.cc).
 *
 * Return-buffer contract matches the reference's MXAPIThreadLocalEntry:
 * pointers handed out are valid until the next API call on the SAME
 * thread (per-thread slot arenas below).
 * ====================================================================== */

typedef uint64_t FunctionHandle;
typedef uint64_t AtomicSymbolCreator;
typedef uint64_t DataIterCreator;
typedef uint64_t DataIterHandle;
typedef uint64_t RecordIOHandle;
typedef uint64_t RtcHandle;
typedef unsigned int mx_uint;

/* ---- per-thread return arenas ---- */
#define MXTPU_SLOTS 8
typedef struct { char **strs; uint32_t n; } StrListSlot;
static __thread StrListSlot g_sl[MXTPU_SLOTS];

static void slot_reset(int s) {
    for (uint32_t i = 0; i < g_sl[s].n; i++) free(g_sl[s].strs[i]);
    free(g_sl[s].strs);
    g_sl[s].strs = NULL;
    g_sl[s].n = 0;
}

/* store a python str sequence into slot s; returns the char** array */
static const char **slot_strlist(int s, PyObject *seq, mx_uint *out_n) {
    slot_reset(s);
    uint32_t n = (uint32_t)PySequence_Size(seq);
    g_sl[s].strs = (char **)calloc(n ? n : 1, sizeof(char *));
    for (uint32_t i = 0; i < n; i++) {
        PyObject *it = PySequence_GetItem(seq, i);
        const char *c = it && PyUnicode_Check(it) ? PyUnicode_AsUTF8(it) : "";
        g_sl[s].strs[i] = strdup(c ? c : "");
        Py_XDECREF(it);
    }
    g_sl[s].n = n;
    if (out_n) *out_n = n;
    return (const char **)g_sl[s].strs;
}

/* store one python str into slot s (index 0) */
static const char *slot_str(int s, PyObject *str) {
    slot_reset(s);
    g_sl[s].strs = (char **)calloc(1, sizeof(char *));
    const char *c = str && PyUnicode_Check(str) ? PyUnicode_AsUTF8(str) : "";
    g_sl[s].strs[0] = strdup(c ? c : "");
    g_sl[s].n = 1;
    return g_sl[s].strs[0];
}

/* per-thread uint64 handle-array buffers */
#define MXTPU_HSLOTS 4
static __thread uint64_t *g_hl[MXTPU_HSLOTS];
static uint64_t *hslot_fill(int s, PyObject *seq, mx_uint *out_n) {
    uint32_t n = (uint32_t)PySequence_Size(seq);
    free(g_hl[s]);
    g_hl[s] = (uint64_t *)calloc(n ? n : 1, sizeof(uint64_t));
    for (uint32_t i = 0; i < n; i++) {
        PyObject *it = PySequence_GetItem(seq, i);
        g_hl[s][i] = PyLong_AsUnsignedLongLong(it);
        Py_XDECREF(it);
    }
    if (out_n) *out_n = n;
    return g_hl[s];
}

/* build a python list of uint64 handles (NULL array -> empty list) */
static PyObject *hlist(const uint64_t *hs, uint32_t n) {
    if (!hs) n = 0;
    PyObject *l = PyList_New(n);
    for (uint32_t i = 0; i < n; i++)
        PyList_SetItem(l, i, PyLong_FromUnsignedLongLong(hs[i]));
    return l;
}

/* build a python list of strings (NULL -> empty list) */
static PyObject *slist(const char **ss, uint32_t n) {
    if (!ss) n = 0;
    PyObject *l = PyList_New(n);
    for (uint32_t i = 0; i < n; i++)
        PyList_SetItem(l, i, PyUnicode_FromString(ss[i] ? ss[i] : ""));
    return l;
}

/* common call shapes.
 *
 * The ``args`` expression at every call site builds Python objects
 * (Py_BuildValue / hlist / slist) and therefore MUST run under the GIL —
 * these are GNU statement-expression macros so the GIL is acquired BEFORE
 * the argument expression is evaluated (a plain function would evaluate
 * args at the call site, GIL-less: immediate segfault on 3.12). */
static int call_void_locked(const char *fn, PyObject *args) {
    PyObject *v = capi_call(fn, args);
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    return rc;
}

static int call_out_u64_locked(const char *fn, PyObject *args,
                               uint64_t *out) {
    PyObject *v = capi_call(fn, args);
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    return rc;
}

static int call_out_int_locked(const char *fn, PyObject *args, int *out) {
    PyObject *v = capi_call(fn, args);
    int rc = -1;
    if (v) { *out = (int)PyLong_AsLong(v); Py_DECREF(v); rc = 0; }
    return rc;
}

static int call_out_str_locked(const char *fn, PyObject *args, int slot,
                               const char **out) {
    PyObject *v = capi_call(fn, args);
    int rc = -1;
    if (v) { *out = slot_str(slot, v); Py_DECREF(v); rc = 0; }
    return rc;
}

static int call_out_strlist_locked(const char *fn, PyObject *args, int slot,
                                   mx_uint *out_n, const char ***out_arr) {
    PyObject *v = capi_call(fn, args);
    int rc = -1;
    if (v) { *out_arr = slot_strlist(slot, v, out_n); Py_DECREF(v); rc = 0; }
    return rc;
}

#define WITH_GIL(expr)                               \
    ({                                               \
        PyGILState_STATE _g = PyGILState_Ensure();   \
        int _rc = (expr);                            \
        PyGILState_Release(_g);                      \
        _rc;                                         \
    })

#define call_void(fn, args) WITH_GIL(call_void_locked(fn, args))
#define call_out_u64(fn, args, out) \
    WITH_GIL(call_out_u64_locked(fn, args, out))
#define call_out_int(fn, args, out) \
    WITH_GIL(call_out_int_locked(fn, args, out))
#define call_out_str(fn, args, slot, out) \
    WITH_GIL(call_out_str_locked(fn, args, slot, out))
#define call_out_strlist(fn, args, slot, out_n, out_arr) \
    WITH_GIL(call_out_strlist_locked(fn, args, slot, out_n, out_arr))

/* ---------------- NDArray (remaining) ---------------- */

MXTPU_EXPORT int MXNDArrayCreateNone(NDArrayHandle *out) {
    ENSURE();
    return call_out_u64("MXNDArrayCreateNone", PyTuple_New(0), out);
}

MXTPU_EXPORT int MXNDArrayCreateEx(const mx_uint *shape, mx_uint ndim,
                                   int dev_type, int dev_id, int delay_alloc,
                                   int dtype, NDArrayHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pshape = PyTuple_New(ndim);
    for (mx_uint i = 0; i < ndim; i++)
        PyTuple_SetItem(pshape, i, PyLong_FromUnsignedLong(shape[i]));
    PyObject *v = capi_call("MXNDArrayCreateEx",
                            Py_BuildValue("(Niiii)", pshape, dev_type, dev_id,
                                          delay_alloc, dtype));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArrayAt(NDArrayHandle h, mx_uint idx,
                             NDArrayHandle *out) {
    ENSURE();
    return call_out_u64("MXNDArrayAt", Py_BuildValue("(KI)", h, idx), out);
}

MXTPU_EXPORT int MXNDArraySlice(NDArrayHandle h, mx_uint begin, mx_uint end,
                                NDArrayHandle *out) {
    ENSURE();
    return call_out_u64("MXNDArraySlice",
                        Py_BuildValue("(KII)", h, begin, end), out);
}

MXTPU_EXPORT int MXNDArrayReshape(NDArrayHandle h, int ndim, int *dims,
                                  NDArrayHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pshape = PyTuple_New(ndim);
    for (int i = 0; i < ndim; i++)
        PyTuple_SetItem(pshape, i, PyLong_FromLong(dims[i]));
    PyObject *v = capi_call("MXNDArrayReshape",
                            Py_BuildValue("(KN)", h, pshape));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

static int dtype_name2id(const char *n);

MXTPU_EXPORT int MXNDArrayGetDType(NDArrayHandle h, int *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNDArrayGetDType", Py_BuildValue("(K)", h));
    int rc = -1;
    if (v) {
        /* reference dtype ids (mshadow TypeFlag) */
        *out = dtype_name2id(PyUnicode_AsUTF8(v));
        Py_DECREF(v);
        rc = 0;
    }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArrayGetContext(NDArrayHandle h, int *out_dev_type,
                                     int *out_dev_id) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNDArrayGetContext", Py_BuildValue("(K)", h));
    int rc = -1;
    if (v && PyTuple_Check(v) && PyTuple_Size(v) == 2) {
        *out_dev_type = (int)PyLong_AsLong(PyTuple_GetItem(v, 0));
        *out_dev_id = (int)PyLong_AsLong(PyTuple_GetItem(v, 1));
        rc = 0;
    }
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArrayWaitToRead(NDArrayHandle h) {
    ENSURE();
    return call_void("MXNDArrayWaitToRead", Py_BuildValue("(K)", h));
}

MXTPU_EXPORT int MXNDArrayWaitToWrite(NDArrayHandle h) {
    ENSURE();
    return call_void("MXNDArrayWaitToWrite", Py_BuildValue("(K)", h));
}

/* raw data view: bytes copied into a per-thread buffer */
static __thread char *g_data_buf = NULL;
MXTPU_EXPORT int MXNDArrayGetData(NDArrayHandle h, void **out_pdata) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNDArrayGetData", Py_BuildValue("(K)", h));
    int rc = -1;
    if (v) {
        Py_ssize_t n = PyBytes_Size(v);
        free(g_data_buf);
        g_data_buf = (char *)malloc(n ? n : 1);
        memcpy(g_data_buf, PyBytes_AsString(v), n);
        *out_pdata = g_data_buf;
        Py_DECREF(v);
        rc = 0;
    }
    PyGILState_Release(st);
    return rc;
}

static __thread char *g_raw_buf = NULL;
MXTPU_EXPORT int MXNDArraySaveRawBytes(NDArrayHandle h, size_t *out_size,
                                       const char **out_buf) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNDArraySaveRawBytes", Py_BuildValue("(K)", h));
    int rc = -1;
    if (v) {
        Py_ssize_t n = PyBytes_Size(v);
        free(g_raw_buf);
        g_raw_buf = (char *)malloc(n ? n : 1);
        memcpy(g_raw_buf, PyBytes_AsString(v), n);
        *out_size = (size_t)n;
        *out_buf = g_raw_buf;
        Py_DECREF(v);
        rc = 0;
    }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArrayLoadFromRawBytes(const void *buf, size_t size,
                                           NDArrayHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pb = PyBytes_FromStringAndSize((const char *)buf,
                                             (Py_ssize_t)size);
    PyObject *v = capi_call("MXNDArrayLoadFromRawBytes",
                            Py_BuildValue("(N)", pb));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArraySave(const char *fname, mx_uint num_args,
                               NDArrayHandle *args, const char **keys) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNDArraySave",
                            Py_BuildValue("(sNN)", fname,
                                          hlist(args, num_args),
                                          keys ? slist(keys, num_args)
                                               : (Py_INCREF(Py_None),
                                                  Py_None)));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXNDArrayLoad(const char *fname, mx_uint *out_size,
                               NDArrayHandle **out_arr,
                               mx_uint *out_name_size,
                               const char ***out_names) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXNDArrayLoad", Py_BuildValue("(s)", fname));
    int rc = -1;
    if (v && PyTuple_Check(v) && PyTuple_Size(v) == 2) {
        *out_arr = hslot_fill(0, PyTuple_GetItem(v, 0), out_size);
        *out_names = slot_strlist(0, PyTuple_GetItem(v, 1), out_name_size);
        rc = 0;
    }
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXRandomSeed(int seed) {
    ENSURE();
    return call_void("MXRandomSeed", Py_BuildValue("(i)", seed));
}

/* ---------------- op invocation + Function registry ---------------- */

MXTPU_EXPORT int MXListAllOpNames(mx_uint *out_size, const char ***out_array) {
    ENSURE();
    return call_out_strlist("MXListAllOpNames", PyTuple_New(0), 1,
                            out_size, out_array);
}

MXTPU_EXPORT int MXImperativeInvoke(AtomicSymbolCreator creator,
                                    int num_inputs, NDArrayHandle *inputs,
                                    int *num_outputs, NDArrayHandle **outputs,
                                    int num_params, const char **param_keys,
                                    const char **param_vals) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    /* creator is an index into the sorted op list: resolve its name */
    PyObject *pname = capi_call("MXSymbolGetAtomicSymbolName",
                                Py_BuildValue("(K)", creator));
    int rc = -1;
    if (pname) {
        PyObject *attrs = PyDict_New();
        for (int i = 0; i < num_params; i++) {
            PyObject *pv = PyUnicode_FromString(param_vals[i]);
            PyDict_SetItemString(attrs, param_keys[i], pv);
            Py_XDECREF(pv);
        }
        if (*outputs != NULL) {
            /* reference contract (c_api_ndarray.cc): a caller-supplied
             * output array means write-in-place into those existing
             * NDArray handles (out= semantics) — the handle array, the
             * count and the handles themselves are left untouched */
            PyObject *v = capi_call(
                "MXImperativeInvokeInPlace",
                Py_BuildValue("(NNNN)", pname,
                              hlist(inputs, (uint32_t)num_inputs), attrs,
                              hlist(*outputs, (uint32_t)*num_outputs)));
            if (v) {
                Py_DECREF(v);
                rc = 0;
            }
        } else {
            PyObject *v = capi_call(
                "MXImperativeInvoke",
                Py_BuildValue("(NNN)", pname,
                              hlist(inputs, (uint32_t)num_inputs), attrs));
            if (v) {
                mx_uint n = 0;
                *outputs = hslot_fill(1, v, &n);
                *num_outputs = (int)n;
                Py_DECREF(v);
                rc = 0;
            }
        }
    }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXListFunctions(mx_uint *out_size, FunctionHandle **out_array) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXListFunctions", PyTuple_New(0));
    int rc = -1;
    if (v) { *out_array = hslot_fill(2, v, out_size); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXGetFunction(const char *name, FunctionHandle *out) {
    ENSURE();
    return call_out_u64("MXGetFunction", Py_BuildValue("(s)", name), out);
}

MXTPU_EXPORT int MXFuncGetInfo(FunctionHandle fun, const char **name,
                               const char **description, mx_uint *num_args,
                               const char ***arg_names,
                               const char ***arg_type_infos,
                               const char ***arg_descriptions,
                               const char **return_type) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXFuncGetInfo", Py_BuildValue("(K)", fun));
    int rc = -1;
    if (v && PyTuple_Check(v) && PyTuple_Size(v) == 6) {
        *name = slot_str(2, PyTuple_GetItem(v, 0));
        *description = slot_str(3, PyTuple_GetItem(v, 1));
        *num_args = (mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(v, 2));
        *arg_names = slot_strlist(4, PyTuple_GetItem(v, 3), NULL);
        *arg_type_infos = slot_strlist(5, PyTuple_GetItem(v, 4), NULL);
        *arg_descriptions = slot_strlist(6, PyTuple_GetItem(v, 5), NULL);
        if (return_type) *return_type = "";
        rc = 0;
    }
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXFuncDescribe(FunctionHandle fun, mx_uint *num_use_vars,
                                mx_uint *num_scalars, mx_uint *num_mutate_vars,
                                int *type_mask) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXFuncDescribe", Py_BuildValue("(K)", fun));
    int rc = -1;
    if (v && PyTuple_Check(v) && PyTuple_Size(v) == 4) {
        *num_use_vars = (mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(v, 0));
        *num_scalars = (mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(v, 1));
        *num_mutate_vars =
            (mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(v, 2));
        *type_mask = (int)PyLong_AsLong(PyTuple_GetItem(v, 3));
        rc = 0;
    }
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

static int func_invoke(FunctionHandle fun, NDArrayHandle *use_vars,
                       float *scalar_args, NDArrayHandle *mutate_vars,
                       int num_params, const char **param_keys,
                       const char **param_vals) {
    PyGILState_STATE st = PyGILState_Ensure();
    mx_uint nu = 0, ns = 0, nm = 0;
    int tm = 0;
    PyObject *d = capi_call("MXFuncDescribe", Py_BuildValue("(K)", fun));
    if (d && PyTuple_Check(d) && PyTuple_Size(d) == 4) {
        nu = (mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(d, 0));
        ns = (mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(d, 1));
        nm = (mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(d, 2));
        tm = (int)PyLong_AsLong(PyTuple_GetItem(d, 3));
        (void)tm;
    }
    Py_XDECREF(d);
    PyObject *scal = PyList_New(ns);
    for (mx_uint i = 0; i < ns; i++)
        PyList_SetItem(scal, i, PyFloat_FromDouble(scalar_args[i]));
    PyObject *v;
    if (num_params > 0) {
        v = capi_call("MXFuncInvokeEx",
                      Py_BuildValue("(KNNNNN)", fun, hlist(use_vars, nu), scal,
                                    hlist(mutate_vars, nm),
                                    slist(param_keys, num_params),
                                    slist(param_vals, num_params)));
    } else {
        v = capi_call("MXFuncInvoke",
                      Py_BuildValue("(KNNN)", fun, hlist(use_vars, nu), scal,
                                    hlist(mutate_vars, nm)));
    }
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXFuncInvoke(FunctionHandle fun, NDArrayHandle *use_vars,
                              float *scalar_args, NDArrayHandle *mutate_vars) {
    ENSURE();
    return func_invoke(fun, use_vars, scalar_args, mutate_vars, 0, NULL, NULL);
}

MXTPU_EXPORT int MXFuncInvokeEx(FunctionHandle fun, NDArrayHandle *use_vars,
                                float *scalar_args, NDArrayHandle *mutate_vars,
                                int num_params, const char **param_keys,
                                const char **param_vals) {
    ENSURE();
    return func_invoke(fun, use_vars, scalar_args, mutate_vars, num_params,
                       param_keys, param_vals);
}

/* ---------------- autograd ---------------- */

MXTPU_EXPORT int MXAutogradSetIsTraining(int is_training, int *prev) {
    ENSURE();
    return call_out_int("MXAutogradSetIsTraining",
                        Py_BuildValue("(i)", is_training), prev);
}

MXTPU_EXPORT int MXAutogradMarkVariables(mx_uint num_var,
                                         NDArrayHandle *var_handles,
                                         mx_uint *reqs_array,
                                         NDArrayHandle *grad_handles) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    static const char *req_names[] = {"null", "write", "inplace", "add"};
    PyObject *reqs = PyList_New(num_var);
    for (mx_uint i = 0; i < num_var; i++) {
        mx_uint r = reqs_array ? reqs_array[i] : 1;
        PyList_SetItem(reqs, i, PyUnicode_FromString(
                           r < 4 ? req_names[r] : "write"));
    }
    PyObject *v = capi_call("MXAutogradMarkVariables",
                            Py_BuildValue("(NNN)",
                                          hlist(var_handles, num_var),
                                          hlist(grad_handles, num_var),
                                          reqs));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXAutogradComputeGradient(mx_uint num_output,
                                           NDArrayHandle *output_handles) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXAutogradComputeGradient",
                            Py_BuildValue("(N)",
                                          hlist(output_handles, num_output)));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

/* ---------------- Symbol (remaining) ---------------- */

MXTPU_EXPORT int MXSymbolFree(SymbolHandle h) {
    ENSURE();
    return call_void("MXSymbolFree", Py_BuildValue("(K)", h));
}

MXTPU_EXPORT int MXSymbolCopy(SymbolHandle h, SymbolHandle *out) {
    ENSURE();
    return call_out_u64("MXSymbolCopy", Py_BuildValue("(K)", h), out);
}

MXTPU_EXPORT int MXSymbolCreateFromFile(const char *fname, SymbolHandle *out) {
    ENSURE();
    return call_out_u64("MXSymbolCreateFromFile",
                        Py_BuildValue("(s)", fname), out);
}

MXTPU_EXPORT int MXSymbolSaveToFile(SymbolHandle h, const char *fname) {
    ENSURE();
    return call_void("MXSymbolSaveToFile", Py_BuildValue("(Ks)", h, fname));
}

MXTPU_EXPORT int MXSymbolCreateGroup(mx_uint num_symbols,
                                     SymbolHandle *symbols,
                                     SymbolHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXSymbolCreateGroup",
                            Py_BuildValue("(N)",
                                          hlist(symbols, num_symbols)));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXSymbolGetName(SymbolHandle h, const char **out,
                                 int *success) {
    ENSURE();
    int rc = call_out_str("MXSymbolGetName", Py_BuildValue("(K)", h), 7, out);
    if (success) *success = (rc == 0 && **out) ? 1 : 0;
    return rc;
}

MXTPU_EXPORT int MXSymbolGetAttr(SymbolHandle h, const char *key,
                                 const char **out, int *success) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXSymbolGetAttr", Py_BuildValue("(Ks)", h, key));
    int rc = -1;
    if (v && PyTuple_Check(v) && PyTuple_Size(v) == 2) {
        *out = slot_str(7, PyTuple_GetItem(v, 0));
        *success = (int)PyLong_AsLong(PyTuple_GetItem(v, 1));
        rc = 0;
    }
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXSymbolSetAttr(SymbolHandle h, const char *key,
                                 const char *value) {
    ENSURE();
    return call_void("MXSymbolSetAttr", Py_BuildValue("(Kss)", h, key, value));
}

MXTPU_EXPORT int MXSymbolListAttr(SymbolHandle h, mx_uint *out_size,
                                  const char ***out) {
    ENSURE();
    mx_uint n = 0;
    int rc = call_out_strlist("MXSymbolListAttr", Py_BuildValue("(K)", h), 1,
                              &n, out);
    if (rc == 0) *out_size = n / 2;  /* pairs, ref contract */
    return rc;
}

MXTPU_EXPORT int MXSymbolListAttrShallow(SymbolHandle h, mx_uint *out_size,
                                         const char ***out) {
    ENSURE();
    mx_uint n = 0;
    int rc = call_out_strlist("MXSymbolListAttrShallow",
                              Py_BuildValue("(K)", h), 1, &n, out);
    if (rc == 0) *out_size = n / 2;
    return rc;
}

MXTPU_EXPORT int MXSymbolListOutputs(SymbolHandle h, mx_uint *out_size,
                                     const char ***out_array) {
    ENSURE();
    return call_out_strlist("MXSymbolListOutputs", Py_BuildValue("(K)", h), 1,
                            out_size, out_array);
}

MXTPU_EXPORT int MXSymbolListAuxiliaryStates(SymbolHandle h, mx_uint *out_size,
                                             const char ***out_array) {
    ENSURE();
    return call_out_strlist("MXSymbolListAuxiliaryStates",
                            Py_BuildValue("(K)", h), 2, out_size, out_array);
}

MXTPU_EXPORT int MXSymbolGetInternals(SymbolHandle h, SymbolHandle *out) {
    ENSURE();
    return call_out_u64("MXSymbolGetInternals", Py_BuildValue("(K)", h), out);
}

MXTPU_EXPORT int MXSymbolGetChildren(SymbolHandle h, SymbolHandle *out) {
    ENSURE();
    return call_out_u64("MXSymbolGetChildren", Py_BuildValue("(K)", h), out);
}

MXTPU_EXPORT int MXSymbolGetOutput(SymbolHandle h, mx_uint index,
                                   SymbolHandle *out) {
    ENSURE();
    return call_out_u64("MXSymbolGetOutput", Py_BuildValue("(KI)", h, index),
                        out);
}

MXTPU_EXPORT int MXSymbolGrad(SymbolHandle h, mx_uint num_wrt,
                              const char **wrt, SymbolHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXSymbolGrad",
                            Py_BuildValue("(KN)", h, slist(wrt, num_wrt)));
    int rc = v ? 0 : -1;  /* matches reference: always errors */
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXSymbolPrint(SymbolHandle h, const char **out_str) {
    ENSURE();
    return call_out_str("MXSymbolPrint", Py_BuildValue("(K)", h), 3, out_str);
}

MXTPU_EXPORT int MXExecutorPrint(ExecutorHandle h, const char **out_str) {
    ENSURE();
    return call_out_str("MXExecutorPrint", Py_BuildValue("(K)", h), 3,
                        out_str);
}

/* ---- shape inference: CSR in, three shape groups out ---- */

typedef struct {
    mx_uint *ndims;
    mx_uint **datas;   /* per-shape pointers */
    mx_uint *flat;     /* backing storage */
    mx_uint n;
} ShapeGroup;
static __thread ShapeGroup g_sg[3];

static void shape_group_reset(int g) {
    free(g_sg[g].ndims); free(g_sg[g].datas); free(g_sg[g].flat);
    memset(&g_sg[g], 0, sizeof(ShapeGroup));
}

/* fill group g from a python list of int tuples */
static int shape_group_fill(int g, PyObject *shapes) {
    shape_group_reset(g);
    mx_uint n = (mx_uint)PySequence_Size(shapes);
    size_t total = 0;
    for (mx_uint i = 0; i < n; i++) {
        PyObject *s = PySequence_GetItem(shapes, i);
        total += (size_t)(s && s != Py_None ? PySequence_Size(s) : 0);
        Py_XDECREF(s);
    }
    g_sg[g].n = n;
    g_sg[g].ndims = (mx_uint *)calloc(n ? n : 1, sizeof(mx_uint));
    g_sg[g].datas = (mx_uint **)calloc(n ? n : 1, sizeof(mx_uint *));
    g_sg[g].flat = (mx_uint *)calloc(total ? total : 1, sizeof(mx_uint));
    size_t off = 0;
    for (mx_uint i = 0; i < n; i++) {
        PyObject *s = PySequence_GetItem(shapes, i);
        mx_uint nd = (mx_uint)(s && s != Py_None ? PySequence_Size(s) : 0);
        g_sg[g].ndims[i] = nd;
        g_sg[g].datas[i] = g_sg[g].flat + off;
        for (mx_uint j = 0; j < nd; j++) {
            PyObject *d = PySequence_GetItem(s, j);
            g_sg[g].flat[off + j] = (mx_uint)PyLong_AsUnsignedLong(d);
            Py_XDECREF(d);
        }
        off += nd;
        Py_XDECREF(s);
    }
    return 0;
}

static int infer_shape_impl(const char *fname, SymbolHandle sym,
                            mx_uint num_args, const char **keys,
                            const mx_uint *arg_ind_ptr,
                            const mx_uint *arg_shape_data,
                            mx_uint *in_size, const mx_uint **in_ndim,
                            const mx_uint ***in_data, mx_uint *out_size,
                            const mx_uint **out_ndim, const mx_uint ***out_data,
                            mx_uint *aux_size, const mx_uint **aux_ndim,
                            const mx_uint ***aux_data, int *complete) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pk = PyList_New(num_args), *ps = PyList_New(num_args);
    for (mx_uint i = 0; i < num_args; i++) {
        PyList_SetItem(pk, i, PyUnicode_FromString(keys[i]));
        mx_uint b = arg_ind_ptr[i], e = arg_ind_ptr[i + 1];
        PyObject *shape = PyTuple_New(e - b);
        for (mx_uint j = b; j < e; j++)
            PyTuple_SetItem(shape, j - b,
                            PyLong_FromUnsignedLong(arg_shape_data[j]));
        PyList_SetItem(ps, i, shape);
    }
    PyObject *v = capi_call(fname, Py_BuildValue("(KNN)", sym, pk, ps));
    int rc = -1;
    if (v && PyTuple_Check(v) && PyTuple_Size(v) == 3) {
        /* completeness = no None entries in the arg/output groups; a None
         * is "unknown", an empty tuple is a legitimate scalar shape —
         * ndim alone cannot distinguish them */
        if (complete) {
            *complete = 1;
            for (int g = 0; g < 2; g++) {
                PyObject *lst = PyTuple_GetItem(v, g);
                Py_ssize_t n = PySequence_Size(lst);
                for (Py_ssize_t i = 0; i < n; i++) {
                    PyObject *s = PySequence_GetItem(lst, i);
                    if (s == Py_None) *complete = 0;
                    Py_XDECREF(s);
                }
            }
        }
        shape_group_fill(0, PyTuple_GetItem(v, 0));
        shape_group_fill(1, PyTuple_GetItem(v, 1));
        shape_group_fill(2, PyTuple_GetItem(v, 2));
        *in_size = g_sg[0].n; *in_ndim = g_sg[0].ndims;
        *in_data = (const mx_uint **)g_sg[0].datas;
        *out_size = g_sg[1].n; *out_ndim = g_sg[1].ndims;
        *out_data = (const mx_uint **)g_sg[1].datas;
        *aux_size = g_sg[2].n; *aux_ndim = g_sg[2].ndims;
        *aux_data = (const mx_uint **)g_sg[2].datas;
        rc = 0;
    }
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXSymbolInferShape(SymbolHandle sym, mx_uint num_args,
                                    const char **keys,
                                    const mx_uint *arg_ind_ptr,
                                    const mx_uint *arg_shape_data,
                                    mx_uint *in_size, const mx_uint **in_ndim,
                                    const mx_uint ***in_data,
                                    mx_uint *out_size,
                                    const mx_uint **out_ndim,
                                    const mx_uint ***out_data,
                                    mx_uint *aux_size,
                                    const mx_uint **aux_ndim,
                                    const mx_uint ***aux_data, int *complete) {
    ENSURE();
    return infer_shape_impl("MXSymbolInferShape", sym, num_args, keys,
                            arg_ind_ptr, arg_shape_data, in_size, in_ndim,
                            in_data, out_size, out_ndim, out_data, aux_size,
                            aux_ndim, aux_data, complete);
}

MXTPU_EXPORT int MXSymbolInferShapePartial(
    SymbolHandle sym, mx_uint num_args, const char **keys,
    const mx_uint *arg_ind_ptr, const mx_uint *arg_shape_data,
    mx_uint *in_size, const mx_uint **in_ndim, const mx_uint ***in_data,
    mx_uint *out_size, const mx_uint **out_ndim, const mx_uint ***out_data,
    mx_uint *aux_size, const mx_uint **aux_ndim, const mx_uint ***aux_data,
    int *complete) {
    ENSURE();
    return infer_shape_impl("MXSymbolInferShapePartial", sym, num_args, keys,
                            arg_ind_ptr, arg_shape_data, in_size, in_ndim,
                            in_data, out_size, out_ndim, out_data, aux_size,
                            aux_ndim, aux_data, complete);
}

/* dtype-id based InferType (ref ids as in MXNDArrayGetDType) */
static const char *dtype_id2name(int id) {
    switch (id) {
        case 0: return "float32"; case 1: return "float64";
        case 2: return "float16"; case 3: return "uint8";
        case 4: return "int32"; case 5: return "int8";
        case 6: return "int64"; case 12: return "bfloat16";
        default: return NULL;
    }
}
static int dtype_name2id(const char *n) {
    if (!n) return -1;
    if (!strcmp(n, "float32")) return 0;
    if (!strcmp(n, "float64")) return 1;
    if (!strcmp(n, "float16")) return 2;
    if (!strcmp(n, "uint8")) return 3;
    if (!strcmp(n, "int32")) return 4;
    if (!strcmp(n, "int8")) return 5;
    if (!strcmp(n, "int64")) return 6;
    if (!strcmp(n, "bfloat16")) return 12;
    return -1;
}

static __thread int *g_ty[3];
MXTPU_EXPORT int MXSymbolInferType(SymbolHandle sym, mx_uint num_args,
                                   const char **keys, const int *arg_type_data,
                                   mx_uint *in_size, const int **in_type,
                                   mx_uint *out_size, const int **out_type,
                                   mx_uint *aux_size, const int **aux_type,
                                   int *complete) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pk = PyList_New(num_args), *pt = PyList_New(num_args);
    for (mx_uint i = 0; i < num_args; i++) {
        PyList_SetItem(pk, i, PyUnicode_FromString(keys[i]));
        const char *tn = dtype_id2name(arg_type_data[i]);
        PyList_SetItem(pt, i, PyUnicode_FromString(tn ? tn : "float32"));
    }
    PyObject *v = capi_call("MXSymbolInferType",
                            Py_BuildValue("(KNN)", sym, pk, pt));
    int rc = -1;
    if (v && PyTuple_Check(v) && PyTuple_Size(v) == 3) {
        mx_uint *sizes[3] = {in_size, out_size, aux_size};
        const int **outs[3] = {in_type, out_type, aux_type};
        if (complete) *complete = 1;
        for (int g = 0; g < 3; g++) {
            PyObject *lst = PyTuple_GetItem(v, g);
            mx_uint n = (mx_uint)PySequence_Size(lst);
            free(g_ty[g]);
            g_ty[g] = (int *)calloc(n ? n : 1, sizeof(int));
            for (mx_uint i = 0; i < n; i++) {
                PyObject *it = PySequence_GetItem(lst, i);
                if (it == Py_None) {
                    g_ty[g][i] = -1;
                    if (complete) *complete = 0;
                } else {
                    g_ty[g][i] = dtype_name2id(PyUnicode_AsUTF8(it));
                }
                Py_XDECREF(it);
            }
            *sizes[g] = n;
            *outs[g] = g_ty[g];
        }
        rc = 0;
    }
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

/* ---------------- op introspection ---------------- */

MXTPU_EXPORT int MXSymbolListAtomicSymbolCreators(mx_uint *out_size,
                                                  AtomicSymbolCreator **out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXSymbolListAtomicSymbolCreators",
                            PyTuple_New(0));
    int rc = -1;
    if (v) { *out = hslot_fill(3, v, out_size); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                             const char **name) {
    ENSURE();
    return call_out_str("MXSymbolGetAtomicSymbolName",
                        Py_BuildValue("(K)", creator), 0, name);
}

MXTPU_EXPORT int MXSymbolGetAtomicSymbolInfo(
    AtomicSymbolCreator creator, const char **name, const char **description,
    mx_uint *num_args, const char ***arg_names, const char ***arg_type_infos,
    const char ***arg_descriptions, const char **key_var_num_args,
    const char **return_type) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXSymbolGetAtomicSymbolInfo",
                            Py_BuildValue("(K)", creator));
    int rc = -1;
    if (v && PyTuple_Check(v) && PyTuple_Size(v) == 8) {
        *name = slot_str(0, PyTuple_GetItem(v, 0));
        *description = slot_str(1, PyTuple_GetItem(v, 1));
        *num_args = (mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(v, 2));
        *arg_names = slot_strlist(4, PyTuple_GetItem(v, 3), NULL);
        *arg_type_infos = slot_strlist(5, PyTuple_GetItem(v, 4), NULL);
        *arg_descriptions = slot_strlist(6, PyTuple_GetItem(v, 5), NULL);
        *key_var_num_args = slot_str(2, PyTuple_GetItem(v, 6));
        if (return_type) *return_type = slot_str(3, PyTuple_GetItem(v, 7));
        rc = 0;
    }
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

/* ---------------- Executor (remaining) ---------------- */

MXTPU_EXPORT int MXExecutorFree(ExecutorHandle h) {
    ENSURE();
    return call_void("MXExecutorFree", Py_BuildValue("(K)", h));
}

static PyObject *grad_req_list(const mx_uint *reqs, mx_uint len) {
    static const char *names[] = {"null", "write", "inplace", "add"};
    PyObject *l = PyList_New(len);
    for (mx_uint i = 0; i < len; i++) {
        mx_uint r = reqs ? reqs[i] : 1;
        PyList_SetItem(l, i, PyUnicode_FromString(r < 4 ? names[r] : "write"));
    }
    return l;
}

static int bind_x(const char *fname, SymbolHandle sym, int dev_type,
                  int dev_id, mx_uint num_map, const char **map_keys,
                  const int *map_dev_types, const int *map_dev_ids,
                  mx_uint len, NDArrayHandle *in_args,
                  NDArrayHandle *arg_grad_store, mx_uint *grad_req_type,
                  mx_uint aux_len, NDArrayHandle *aux_states,
                  ExecutorHandle shared_exec, ExecutorHandle *out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *gk = PyList_New(num_map), *gt = PyList_New(num_map),
             *gi = PyList_New(num_map);
    for (mx_uint i = 0; i < num_map; i++) {
        PyList_SetItem(gk, i, PyUnicode_FromString(map_keys[i]));
        PyList_SetItem(gt, i, PyLong_FromLong(map_dev_types[i]));
        PyList_SetItem(gi, i, PyLong_FromLong(map_dev_ids[i]));
    }
    PyObject *args;
    if (shared_exec) {
        args = Py_BuildValue("(KiiNNNNNNNK)", sym, dev_type, dev_id, gk, gt,
                             gi, hlist(in_args, len),
                             hlist(arg_grad_store, len),
                             grad_req_list(grad_req_type, len),
                             hlist(aux_states, aux_len), shared_exec);
    } else {
        args = Py_BuildValue("(KiiNNNNNNN)", sym, dev_type, dev_id, gk, gt,
                             gi, hlist(in_args, len),
                             hlist(arg_grad_store, len),
                             grad_req_list(grad_req_type, len),
                             hlist(aux_states, aux_len));
    }
    PyObject *v = capi_call(fname, args);
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXExecutorBindX(SymbolHandle sym, int dev_type, int dev_id,
                                 mx_uint num_map, const char **map_keys,
                                 const int *map_dev_types,
                                 const int *map_dev_ids, mx_uint len,
                                 NDArrayHandle *in_args,
                                 NDArrayHandle *arg_grad_store,
                                 mx_uint *grad_req_type, mx_uint aux_len,
                                 NDArrayHandle *aux_states,
                                 ExecutorHandle *out) {
    ENSURE();
    return bind_x("MXExecutorBindX", sym, dev_type, dev_id, num_map, map_keys,
                  map_dev_types, map_dev_ids, len, in_args, arg_grad_store,
                  grad_req_type, aux_len, aux_states, 0, out);
}

MXTPU_EXPORT int MXExecutorBindEX(SymbolHandle sym, int dev_type, int dev_id,
                                  mx_uint num_map, const char **map_keys,
                                  const int *map_dev_types,
                                  const int *map_dev_ids, mx_uint len,
                                  NDArrayHandle *in_args,
                                  NDArrayHandle *arg_grad_store,
                                  mx_uint *grad_req_type, mx_uint aux_len,
                                  NDArrayHandle *aux_states,
                                  ExecutorHandle shared_exec,
                                  ExecutorHandle *out) {
    ENSURE();
    return bind_x("MXExecutorBindEX", sym, dev_type, dev_id, num_map,
                  map_keys, map_dev_types, map_dev_ids, len, in_args,
                  arg_grad_store, grad_req_type, aux_len, aux_states,
                  shared_exec, out);
}

typedef void (*ExecutorMonitorCallback)(const char *, NDArrayHandle, void *);

MXTPU_EXPORT int MXExecutorSetMonitorCallback(ExecutorHandle h,
                                              ExecutorMonitorCallback cb,
                                              void *cb_handle) {
    ENSURE();
    return call_void("MXExecutorSetMonitorCallback",
                     Py_BuildValue("(KKK)", h, (uint64_t)(uintptr_t)cb,
                                   (uint64_t)(uintptr_t)cb_handle));
}

/* ---------------- DataIter ---------------- */

MXTPU_EXPORT int MXListDataIters(mx_uint *out_size, DataIterCreator **out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXListDataIters", PyTuple_New(0));
    int rc = -1;
    if (v) { *out = hslot_fill(3, v, out_size); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXDataIterGetIterInfo(DataIterCreator creator,
                                       const char **name,
                                       const char **description,
                                       mx_uint *num_args,
                                       const char ***arg_names,
                                       const char ***arg_type_infos,
                                       const char ***arg_descriptions) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXDataIterGetIterInfo",
                            Py_BuildValue("(K)", creator));
    int rc = -1;
    if (v && PyTuple_Check(v) && PyTuple_Size(v) == 6) {
        *name = slot_str(0, PyTuple_GetItem(v, 0));
        *description = slot_str(1, PyTuple_GetItem(v, 1));
        *num_args = (mx_uint)PyLong_AsUnsignedLong(PyTuple_GetItem(v, 2));
        *arg_names = slot_strlist(4, PyTuple_GetItem(v, 3), NULL);
        *arg_type_infos = slot_strlist(5, PyTuple_GetItem(v, 4), NULL);
        *arg_descriptions = slot_strlist(6, PyTuple_GetItem(v, 5), NULL);
        rc = 0;
    }
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXDataIterCreateIter(DataIterCreator creator,
                                      mx_uint num_param, const char **keys,
                                      const char **vals,
                                      DataIterHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXDataIterCreateIter",
                            Py_BuildValue("(KNN)", creator,
                                          slist(keys, num_param),
                                          slist(vals, num_param)));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXDataIterFree(DataIterHandle h) {
    ENSURE();
    return call_void("MXDataIterFree", Py_BuildValue("(K)", h));
}

MXTPU_EXPORT int MXDataIterNext(DataIterHandle h, int *out) {
    ENSURE();
    return call_out_int("MXDataIterNext", Py_BuildValue("(K)", h), out);
}

MXTPU_EXPORT int MXDataIterBeforeFirst(DataIterHandle h) {
    ENSURE();
    return call_void("MXDataIterBeforeFirst", Py_BuildValue("(K)", h));
}

MXTPU_EXPORT int MXDataIterGetData(DataIterHandle h, NDArrayHandle *out) {
    ENSURE();
    return call_out_u64("MXDataIterGetData", Py_BuildValue("(K)", h), out);
}

MXTPU_EXPORT int MXDataIterGetLabel(DataIterHandle h, NDArrayHandle *out) {
    ENSURE();
    return call_out_u64("MXDataIterGetLabel", Py_BuildValue("(K)", h), out);
}

static __thread uint64_t *g_idx_buf = NULL;
MXTPU_EXPORT int MXDataIterGetIndex(DataIterHandle h, uint64_t **out_index,
                                    uint64_t *out_size) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXDataIterGetIndex", Py_BuildValue("(K)", h));
    int rc = -1;
    if (v) {
        uint64_t n = (uint64_t)PySequence_Size(v);
        free(g_idx_buf);
        g_idx_buf = (uint64_t *)calloc(n ? n : 1, sizeof(uint64_t));
        for (uint64_t i = 0; i < n; i++) {
            PyObject *it = PySequence_GetItem(v, i);
            g_idx_buf[i] = PyLong_AsUnsignedLongLong(it);
            Py_XDECREF(it);
        }
        *out_index = g_idx_buf;
        *out_size = n;
        Py_DECREF(v);
        rc = 0;
    }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXDataIterGetPadNum(DataIterHandle h, int *pad) {
    ENSURE();
    return call_out_int("MXDataIterGetPadNum", Py_BuildValue("(K)", h), pad);
}

/* ---------------- RecordIO ---------------- */

MXTPU_EXPORT int MXRecordIOWriterCreate(const char *uri, RecordIOHandle *out) {
    ENSURE();
    return call_out_u64("MXRecordIOWriterCreate", Py_BuildValue("(s)", uri),
                        out);
}

MXTPU_EXPORT int MXRecordIOWriterFree(RecordIOHandle h) {
    ENSURE();
    return call_void("MXRecordIOWriterFree", Py_BuildValue("(K)", h));
}

MXTPU_EXPORT int MXRecordIOWriterWriteRecord(RecordIOHandle h, const char *buf,
                                             size_t size) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pb = PyBytes_FromStringAndSize(buf, (Py_ssize_t)size);
    PyObject *v = capi_call("MXRecordIOWriterWriteRecord",
                            Py_BuildValue("(KN)", h, pb));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXRecordIOWriterTell(RecordIOHandle h, size_t *pos) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXRecordIOWriterTell", Py_BuildValue("(K)", h));
    int rc = -1;
    if (v) { *pos = (size_t)PyLong_AsUnsignedLongLong(v); Py_DECREF(v);
             rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXRecordIOReaderCreate(const char *uri, RecordIOHandle *out) {
    ENSURE();
    return call_out_u64("MXRecordIOReaderCreate", Py_BuildValue("(s)", uri),
                        out);
}

MXTPU_EXPORT int MXRecordIOReaderFree(RecordIOHandle h) {
    ENSURE();
    return call_void("MXRecordIOReaderFree", Py_BuildValue("(K)", h));
}

static __thread char *g_rec_buf = NULL;
MXTPU_EXPORT int MXRecordIOReaderReadRecord(RecordIOHandle h,
                                            char const **buf, size_t *size) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXRecordIOReaderReadRecord",
                            Py_BuildValue("(K)", h));
    int rc = -1;
    if (v) {
        Py_ssize_t n = PyBytes_Size(v);
        free(g_rec_buf);
        g_rec_buf = (char *)malloc(n ? n : 1);
        memcpy(g_rec_buf, PyBytes_AsString(v), n);
        *buf = n ? g_rec_buf : NULL;  /* NULL at EOF, ref contract */
        *size = (size_t)n;
        Py_DECREF(v);
        rc = 0;
    }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXRecordIOReaderSeek(RecordIOHandle h, size_t pos) {
    ENSURE();
    return call_void("MXRecordIOReaderSeek", Py_BuildValue("(KK)", h,
                                                           (uint64_t)pos));
}

/* ---------------- Rtc ---------------- */

MXTPU_EXPORT int MXRtcCreate(char *name, mx_uint num_input, mx_uint num_output,
                             char **input_names, char **output_names,
                             NDArrayHandle *inputs, NDArrayHandle *outputs,
                             char *kernel, RtcHandle *out) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call(
        "MXRtcCreate",
        Py_BuildValue("(sNNNNs)", name,
                      slist((const char **)input_names, num_input),
                      slist((const char **)output_names, num_output),
                      hlist(inputs, num_input), hlist(outputs, num_output),
                      kernel));
    int rc = -1;
    if (v) { *out = PyLong_AsUnsignedLongLong(v); Py_DECREF(v); rc = 0; }
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXRtcPush(RtcHandle h, mx_uint num_input, mx_uint num_output,
                           NDArrayHandle *inputs, NDArrayHandle *outputs,
                           mx_uint gridDimX, mx_uint gridDimY,
                           mx_uint gridDimZ, mx_uint blockDimX,
                           mx_uint blockDimY, mx_uint blockDimZ) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call(
        "MXRtcPush",
        Py_BuildValue("(KNNIIIIII)", h, hlist(inputs, num_input),
                      hlist(outputs, num_output), gridDimX, gridDimY,
                      gridDimZ, blockDimX, blockDimY, blockDimZ));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXRtcFree(RtcHandle h) {
    ENSURE();
    return call_void("MXRtcFree", Py_BuildValue("(K)", h));
}

/* ---------------- profiler ---------------- */

MXTPU_EXPORT int MXSetProfilerConfig(int mode, const char *filename) {
    ENSURE();
    return call_void("MXSetProfilerConfig",
                     Py_BuildValue("(is)", mode, filename));
}

MXTPU_EXPORT int MXSetProfilerState(int state) {
    ENSURE();
    return call_void("MXSetProfilerState", Py_BuildValue("(i)", state));
}

MXTPU_EXPORT int MXDumpProfile(void) {
    ENSURE();
    return call_void("MXDumpProfile", PyTuple_New(0));
}

/* ---------------- KVStore (remaining) ---------------- */

MXTPU_EXPORT int MXKVStoreFree(KVStoreHandle h) {
    ENSURE();
    return call_void("MXKVStoreFree", Py_BuildValue("(K)", h));
}

MXTPU_EXPORT int MXKVStoreGetType(KVStoreHandle h, const char **type) {
    ENSURE();
    return call_out_str("MXKVStoreGetType", Py_BuildValue("(K)", h), 7, type);
}

MXTPU_EXPORT int MXKVStoreGetRank(KVStoreHandle h, int *rank) {
    ENSURE();
    return call_out_int("MXKVStoreGetRank", Py_BuildValue("(K)", h), rank);
}

MXTPU_EXPORT int MXKVStoreGetGroupSize(KVStoreHandle h, int *size) {
    ENSURE();
    return call_out_int("MXKVStoreGetGroupSize", Py_BuildValue("(K)", h),
                        size);
}

MXTPU_EXPORT int MXKVStoreBarrier(KVStoreHandle h) {
    ENSURE();
    return call_void("MXKVStoreBarrier", Py_BuildValue("(K)", h));
}

MXTPU_EXPORT int MXKVStoreGetNumDeadNode(KVStoreHandle h, const int node_id,
                                         int *number, const int timeout_sec) {
    ENSURE();
    return call_out_int("MXKVStoreGetNumDeadNode",
                        Py_BuildValue("(Kii)", h, node_id, timeout_sec),
                        number);
}

MXTPU_EXPORT int MXKVStoreIsWorkerNode(int *ret) {
    ENSURE();
    return call_out_int("MXKVStoreIsWorkerNode", PyTuple_New(0), ret);
}

MXTPU_EXPORT int MXKVStoreIsServerNode(int *ret) {
    ENSURE();
    return call_out_int("MXKVStoreIsServerNode", PyTuple_New(0), ret);
}

MXTPU_EXPORT int MXKVStoreIsSchedulerNode(int *ret) {
    ENSURE();
    return call_out_int("MXKVStoreIsSchedulerNode", PyTuple_New(0), ret);
}

MXTPU_EXPORT int MXKVStoreRunServer(KVStoreHandle h,
                                    void *controller, void *controller_handle) {
    ENSURE();
    (void)controller; (void)controller_handle;
    return call_void("MXKVStoreRunServer", Py_BuildValue("(K)", h));
}

/* Length-explicit variant: command bodies are arbitrary bytes (the cmd_id 0
 * kController body is a pickled optimizer, which contains NULs), so the
 * NUL-terminated legacy signature cannot carry them faithfully. */
MXTPU_EXPORT int MXKVStoreSendCommmandToServersEx(KVStoreHandle h, int cmd_id,
                                                  const char *cmd_body,
                                                  size_t body_len) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *pb = PyBytes_FromStringAndSize(cmd_body ? cmd_body : "",
                                             cmd_body ? (Py_ssize_t)body_len
                                                      : 0);
    PyObject *v = capi_call("MXKVStoreSendCommmandToServers",
                            Py_BuildValue("(KiN)", h, cmd_id, pb));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

MXTPU_EXPORT int MXKVStoreSendCommmandToServers(KVStoreHandle h, int cmd_id,
                                                const char *cmd_body) {
    /* legacy NUL-terminated entry point: delegate with an explicit length
     * so the marshalled body is exactly what strlen sees (binary bodies
     * must use the Ex variant) */
    return MXKVStoreSendCommmandToServersEx(
        h, cmd_id, cmd_body, cmd_body ? strlen(cmd_body) : 0);
}

MXTPU_EXPORT int MXKVStoreSetBarrierBeforeExit(KVStoreHandle h,
                                               const int do_barrier) {
    ENSURE();
    return call_void("MXKVStoreSetBarrierBeforeExit",
                     Py_BuildValue("(Ki)", h, do_barrier));
}

typedef void (MXKVStoreUpdater)(int key, NDArrayHandle recv,
                                NDArrayHandle local, void *handle);

MXTPU_EXPORT int MXKVStoreSetUpdater(KVStoreHandle h, MXKVStoreUpdater updater,
                                     void *updater_handle) {
    ENSURE();
    return call_void("MXKVStoreSetUpdater",
                     Py_BuildValue("(KKK)", h, (uint64_t)(uintptr_t)updater,
                                   (uint64_t)(uintptr_t)updater_handle));
}

MXTPU_EXPORT int MXInitPSEnv(mx_uint num_vars, const char **keys,
                             const char **vals) {
    ENSURE();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *v = capi_call("MXInitPSEnv",
                            Py_BuildValue("(NN)", slist(keys, num_vars),
                                          slist(vals, num_vars)));
    int rc = v ? 0 : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return rc;
}

/* ---------------- CustomOp ---------------- */

MXTPU_EXPORT int MXCustomOpRegister(const char *op_type, void *creator) {
    ENSURE();
    return call_void("MXCustomOpRegister",
                     Py_BuildValue("(sK)", op_type,
                                   (uint64_t)(uintptr_t)creator));
}
