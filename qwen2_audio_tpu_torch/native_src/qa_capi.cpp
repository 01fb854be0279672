// C ABI shim mirroring include/qwen2-whisper.h on the PyTorch/CUDA port.
//
// The reference exposes a C API (whisper_init_from_file_with_params,
// whisper_full, accessors — include/qwen2-whisper.h:141-527). This shim
// provides the same entry points as a real C ABI by embedding CPython and
// delegating to qwen2_audio_tpu_torch.capi, so C/C++ applications written
// against whisper.cpp can link against it and run on the card.
//
// Device: whisper_init_from_file uses the default context parameters, which
// run on the card (cuda:0). whisper_init_from_file_with_params reads the
// leading `bool use_gpu` of whisper.cpp v1.7.1's struct
// whisper_context_params (use_gpu, flash_attn, gpu_device, ...) when
// `params` is not null; use_gpu = false runs the context on the CPU. The
// port takes no environment switches, so this is the only way to ask for
// the CPU.
//
// Threading contract: EVERY Python C-API call (including argument
// construction) happens under the GIL, and the interpreter is lazily
// initialized on the first call of ANY entry point. Audio buffers cross the
// boundary as one bytes object (np.frombuffer on the Python side), not as
// boxed per-sample floats. The embedded interpreter finds the package and
// its dependencies through PYTHONPATH.
//
// Build: qwen2_audio_tpu_torch.native.build_capi() (g++ with
// `python3-config --embed --cflags --ldflags`).

#include <Python.h>

#include <cstdarg>
#include <cstdio>
#include <cstring>
#include <mutex>

namespace {

std::once_flag g_init_once;
PyObject* g_capi = nullptr;   // module qwen2_audio_tpu_torch.capi

void ensure_python() {
    std::call_once(g_init_once, [] {
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);
        }
        PyGILState_STATE s = PyGILState_Ensure();
        g_capi = PyImport_ImportModule("qwen2_audio_tpu_torch.capi");
        if (!g_capi) {
            PyErr_Print();
            std::fprintf(stderr,
                         "qa_capi: failed to import qwen2_audio_tpu_torch.capi "
                         "(is the repo on PYTHONPATH?)\n");
        }
        PyGILState_Release(s);
    });
}

struct Gil {
    PyGILState_STATE s;
    Gil() { ensure_python(); s = PyGILState_Ensure(); }
    ~Gil() { PyGILState_Release(s); }
};

// call with args built from a Py_BuildValue tuple format — must hold the GIL
PyObject* call_locked(const char* fn, PyObject* args /* stolen */) {
    if (!g_capi) { Py_XDECREF(args); return nullptr; }
    PyObject* f = PyObject_GetAttrString(g_capi, fn);
    if (!f) { PyErr_Print(); Py_XDECREF(args); return nullptr; }
    PyObject* r = PyObject_CallObject(f, args);
    Py_DECREF(f);
    Py_XDECREF(args);
    if (!r) PyErr_Print();
    return r;
}

PyObject* vcall(const char* fn, const char* fmt, va_list va) {
    PyObject* args = (fmt && *fmt) ? Py_VaBuildValue(fmt, va)
                                   : PyTuple_New(0);
    return call_locked(fn, args);
}

long call_long(const char* fn, const char* fmt, ...) {
    Gil gil;
    va_list va;
    va_start(va, fmt);
    PyObject* r = vcall(fn, fmt, va);
    va_end(va);
    if (!r) return -1;
    long v = PyLong_Check(r) ? PyLong_AsLong(r) : -1;
    Py_DECREF(r);
    return v;
}

void call_void(const char* fn, const char* fmt, ...) {
    Gil gil;
    va_list va;
    va_start(va, fmt);
    PyObject* r = vcall(fn, fmt, va);
    va_end(va);
    Py_XDECREF(r);
}

}  // namespace

extern "C" {

typedef void whisper_context;  // opaque: PyObject*

// the leading members of whisper.cpp v1.7.1's struct whisper_context_params
struct whisper_context_params_head {
    bool use_gpu;
    bool flash_attn;
    int gpu_device;
};

whisper_context* whisper_init_from_file_with_params(const char* path_model,
                                                    void* params) {
    Gil gil;
    PyObject* cp = call_locked("whisper_context_default_params", PyTuple_New(0));
    if (!cp) return nullptr;
    if (params) {
        bool use_gpu = static_cast<const whisper_context_params_head*>(params)->use_gpu;
        if (PyObject_SetAttrString(cp, "use_gpu", use_gpu ? Py_True : Py_False) != 0) {
            PyErr_Print();
            Py_DECREF(cp);
            return nullptr;
        }
    }
    PyObject* args = Py_BuildValue("(sO)", path_model, cp);
    Py_DECREF(cp);
    return (whisper_context*)call_locked(
        "whisper_init_from_file_with_params", args);
}

whisper_context* whisper_init_from_file(const char* path_model) {
    return whisper_init_from_file_with_params(path_model, nullptr);
}

void whisper_free(whisper_context* ctx) {
    if (!ctx) return;
    Gil gil;
    Py_DECREF((PyObject*)ctx);
}

int whisper_pcm_to_mel(whisper_context* ctx, const float* samples,
                       int n_samples, int /*n_threads*/) {
    Gil gil;
    PyObject* buf = PyBytes_FromStringAndSize(
        (const char*)samples, (Py_ssize_t)n_samples * 4);
    PyObject* args = PyTuple_Pack(2, (PyObject*)ctx, buf);
    Py_XDECREF(buf);
    PyObject* r = call_locked("_pcm_to_mel_from_bytes", args);
    if (!r) return -1;
    int v = (int)PyLong_AsLong(r);
    Py_DECREF(r);
    return v;
}

int whisper_encode(whisper_context* ctx, int offset, int n_threads) {
    return (int)call_long("whisper_encode", "(Oii)", (PyObject*)ctx, offset,
                          n_threads);
}

int whisper_full(whisper_context* ctx, void* /*params*/,
                 const float* samples, int n_samples) {
    Gil gil;
    PyObject* buf = PyBytes_FromStringAndSize(
        (const char*)samples, (Py_ssize_t)n_samples * 4);
    PyObject* args = PyTuple_Pack(2, (PyObject*)ctx, buf);
    Py_XDECREF(buf);
    PyObject* r = call_locked("_full_from_bytes", args);
    if (!r) return -1;
    int v = (int)PyLong_AsLong(r);
    Py_DECREF(r);
    return v;
}

void whisper_print_emb_enc(whisper_context* ctx) {
    call_void("whisper_print_emb_enc", "(O)", (PyObject*)ctx);
}

#define INT_ACCESSOR(NAME)                                              \
    int NAME(whisper_context* ctx) {                                   \
        return (int)call_long(#NAME, "(O)", (PyObject*)ctx);            \
    }

INT_ACCESSOR(whisper_n_len)
INT_ACCESSOR(whisper_n_vocab)
INT_ACCESSOR(whisper_n_text_ctx)
INT_ACCESSOR(whisper_n_audio_ctx)
INT_ACCESSOR(whisper_is_multilingual)
INT_ACCESSOR(whisper_model_n_mels)
INT_ACCESSOR(whisper_model_ftype)
INT_ACCESSOR(whisper_token_eot)
INT_ACCESSOR(whisper_token_sot)
INT_ACCESSOR(whisper_token_beg)
INT_ACCESSOR(whisper_full_n_segments)

int whisper_lang_id(const char* lang) {
    return (int)call_long("whisper_lang_id", "(s)", lang);
}

int whisper_lang_max_id(void) {
    return (int)call_long("whisper_lang_max_id", "");
}

const char* whisper_lang_str(int id) {
    Gil gil;
    static thread_local char buf[16];
    PyObject* args = Py_BuildValue("(i)", id);
    PyObject* r = call_locked("whisper_lang_str", args);
    if (!r || r == Py_None) { Py_XDECREF(r); return nullptr; }
    const char* s = PyUnicode_AsUTF8(r);
    std::snprintf(buf, sizeof(buf), "%s", s ? s : "");
    Py_DECREF(r);
    return buf;
}

const char* whisper_full_get_segment_text(whisper_context* ctx, int i) {
    Gil gil;
    static thread_local char buf[4096];
    PyObject* args = Py_BuildValue("(Oi)", (PyObject*)ctx, i);
    PyObject* r = call_locked("whisper_full_get_segment_text", args);
    if (!r) return nullptr;
    const char* s = PyUnicode_AsUTF8(r);
    std::snprintf(buf, sizeof(buf), "%s", s ? s : "");
    Py_DECREF(r);
    return buf;
}

void whisper_print_timings(whisper_context* ctx) {
    call_void("whisper_print_timings", "(O)", (PyObject*)ctx);
}

// Not in the reference's header: the device the context's tensors are on,
// as torch names it (str(ctx.device): "cuda:0", "cpu"); null on failure.
const char* qa_context_device(whisper_context* ctx) {
    Gil gil;
    static thread_local char buf[64];
    PyObject* dev = PyObject_GetAttrString((PyObject*)ctx, "device");
    PyObject* r = dev ? PyObject_Str(dev) : nullptr;
    Py_XDECREF(dev);
    const char* s = r ? PyUnicode_AsUTF8(r) : nullptr;
    if (!s) { PyErr_Print(); Py_XDECREF(r); return nullptr; }
    std::snprintf(buf, sizeof(buf), "%s", s);
    Py_DECREF(r);
    return buf;
}

}  // extern "C"
