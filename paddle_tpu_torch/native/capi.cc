// C inference API over an embedded CPython running the port's executor,
// the port of paddle_tpu/native/capi.cc: the same symbols and marshalling
// over paddle_tpu_torch.capi_runtime.
//
// Reference precedent (SURVEY.md §2.6, §2.14): paddle/capi exposed C symbols
// for deployment, and the C++ trainer itself embedded Python
// (utils/PythonUtil.h:47) for config parsing and data providers.  Here the
// whole inference runtime lives behind paddle_tpu_torch.capi_runtime; this
// file is only ABI + marshalling: buffers cross as PyBytes, shapes as
// tuples.  An engine runs on the card unless the environment asks for the
// CPU (PADDLE_TPU_TORCH_CAPI_PLACE=cpu).  paddle_capi_shutdown drops the
// engines and waits for the card before it finalizes an interpreter this
// library created.
//
// Build (native/capi.py build_lib): g++ -O2 -shared -fPIC -std=c++17
//   capi.cc -o libpaddle_capi_<hash>.so -I<python include>
//   [-L<libdir> -lpython3.x where Python is a shared library]

#include "capi.h"

#include <Python.h>

#include <cstring>
#include <string>

namespace {

thread_local std::string g_last_error;
bool g_we_initialized = false;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* msg = PyUnicode_AsUTF8(s);
      g_last_error = msg != nullptr ? msg : "<unprintable python error>";
      Py_DECREF(s);
    }
  } else {
    g_last_error = "unknown python error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
}

// RAII GIL hold: every public entry point may be called from any host thread.
class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

PyObject* runtime_module() {
  static PyObject* mod = nullptr;  // borrowed forever once imported
  if (mod == nullptr) {
    mod = PyImport_ImportModule("paddle_tpu_torch.capi_runtime");
    if (mod == nullptr) set_error_from_python();
  }
  return mod;
}

// Call capi_runtime.<fn>(*args). Returns new reference or nullptr.
PyObject* call_runtime(const char* fn, PyObject* args) {
  PyObject* mod = runtime_module();
  if (mod == nullptr) {
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(mod, fn);
  if (f == nullptr) {
    set_error_from_python();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* res = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (res == nullptr) set_error_from_python();
  return res;
}

}  // namespace

extern "C" {

int paddle_capi_init(const char* python_path_extra) {
  if (Py_IsInitialized() == 0) {
    Py_InitializeEx(0);
    g_we_initialized = true;
    // Py_InitializeEx leaves the GIL held by this thread; release it so Gil
    // (PyGILState_Ensure) works uniformly from every thread afterwards.
    PyEval_SaveThread();
  }
  Gil gil;
  if (g_we_initialized && PySys_GetObject("argv") == nullptr) {
    // an embedded interpreter may have no sys.argv; modules read it
    PyObject* argv = Py_BuildValue("[s]", "paddle_capi");
    if (argv != nullptr) {
      PySys_SetObject("argv", argv);
      Py_DECREF(argv);
    }
  }
  if (python_path_extra != nullptr && python_path_extra[0] != '\0') {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    if (sys_path != nullptr) {
      PyObject* p = PyUnicode_FromString(python_path_extra);
      if (p != nullptr) {
        PyList_Append(sys_path, p);
        Py_DECREF(p);
      }
    }
  }
  if (runtime_module() == nullptr) return PD_ERROR;
  return PD_OK;
}

int paddle_capi_shutdown(void) {
  // finalize only when this library did the initialization — never tear
  // down a host application's interpreter
  if (!g_we_initialized || Py_IsInitialized() == 0) return PD_OK;
  PyGILState_Ensure();  // Py_FinalizeEx requires the GIL
  // drop the engines and wait for the card while the runtime still runs
  PyObject* res = call_runtime("shutdown", PyTuple_New(0));
  if (res == nullptr) return PD_ERROR;
  Py_DECREF(res);
  g_we_initialized = false;
  return Py_FinalizeEx() == 0 ? PD_OK : PD_ERROR;
}

const char* paddle_capi_last_error(void) { return g_last_error.c_str(); }

int paddle_inference_create(const char* model_dir, int64_t* out) {
  if (Py_IsInitialized() == 0) return PD_NOT_INITIALIZED;
  Gil gil;
  PyObject* res = call_runtime("create", Py_BuildValue("(s)", model_dir));
  if (res == nullptr) return PD_ERROR;
  *out = PyLong_AsLongLong(res);
  Py_DECREF(res);
  return PD_OK;
}

int paddle_inference_set_input(int64_t engine, const char* name,
                               const void* data, const int64_t* shape,
                               int rank, paddle_dtype dtype) {
  if (Py_IsInitialized() == 0) return PD_NOT_INITIALIZED;
  Gil gil;
  int64_t numel = 1;
  for (int i = 0; i < rank; ++i) numel *= shape[i];
  const int64_t item = (dtype == PD_INT64 || dtype == PD_FLOAT64) ? 8 : 4;
  PyObject* shape_tuple = PyTuple_New(rank);
  if (shape_tuple == nullptr) return PD_ERROR;
  for (int i = 0; i < rank; ++i) {
    PyTuple_SET_ITEM(shape_tuple, i, PyLong_FromLongLong(shape[i]));
  }
  PyObject* payload = PyBytes_FromStringAndSize(
      static_cast<const char*>(data), numel * item);
  if (payload == nullptr) {
    Py_DECREF(shape_tuple);
    set_error_from_python();
    return PD_ERROR;
  }
  PyObject* args = Py_BuildValue("(LsNNi)", static_cast<long long>(engine),
                                 name, payload, shape_tuple,
                                 static_cast<int>(dtype));
  if (args == nullptr) {
    set_error_from_python();
    return PD_ERROR;
  }
  PyObject* res = call_runtime("set_input", args);
  if (res == nullptr) return PD_ERROR;
  Py_DECREF(res);
  return PD_OK;
}

int paddle_inference_run(int64_t engine, int* n_outputs) {
  if (Py_IsInitialized() == 0) return PD_NOT_INITIALIZED;
  Gil gil;
  PyObject* res = call_runtime(
      "run", Py_BuildValue("(L)", static_cast<long long>(engine)));
  if (res == nullptr) return PD_ERROR;
  if (n_outputs != nullptr) *n_outputs = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return PD_OK;
}

int paddle_inference_output_shape(int64_t engine, int index, int64_t* shape,
                                  int max_rank, int* rank) {
  if (Py_IsInitialized() == 0) return PD_NOT_INITIALIZED;
  Gil gil;
  PyObject* res = call_runtime(
      "output_shape",
      Py_BuildValue("(Li)", static_cast<long long>(engine), index));
  if (res == nullptr) return PD_ERROR;
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(res, &buf, &len) != 0) {
    set_error_from_python();
    Py_DECREF(res);
    return PD_ERROR;
  }
  const int r = static_cast<int>(len / sizeof(int64_t));
  if (rank != nullptr) *rank = r;
  const int n = r < max_rank ? r : max_rank;
  std::memcpy(shape, buf, n * sizeof(int64_t));
  Py_DECREF(res);
  return PD_OK;
}

int paddle_inference_output_dtype(int64_t engine, int index,
                                  paddle_dtype* dtype) {
  if (Py_IsInitialized() == 0) return PD_NOT_INITIALIZED;
  Gil gil;
  PyObject* res = call_runtime(
      "output_dtype",
      Py_BuildValue("(Li)", static_cast<long long>(engine), index));
  if (res == nullptr) return PD_ERROR;
  if (dtype != nullptr) {
    *dtype = static_cast<paddle_dtype>(PyLong_AsLong(res));
  }
  Py_DECREF(res);
  return PD_OK;
}

int64_t paddle_inference_output_data(int64_t engine, int index, void* buf,
                                     int64_t buf_bytes) {
  if (Py_IsInitialized() == 0) return PD_NOT_INITIALIZED;
  Gil gil;
  PyObject* res = call_runtime(
      "output_data",
      Py_BuildValue("(Li)", static_cast<long long>(engine), index));
  if (res == nullptr) return PD_ERROR;
  char* src = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(res, &src, &len) != 0) {
    set_error_from_python();
    Py_DECREF(res);
    return PD_ERROR;
  }
  if (len > buf_bytes) {
    g_last_error = "output buffer too small";
    Py_DECREF(res);
    return PD_ERROR;
  }
  std::memcpy(buf, src, len);
  Py_DECREF(res);
  return len;
}

int paddle_inference_release(int64_t engine) {
  if (Py_IsInitialized() == 0) return PD_NOT_INITIALIZED;
  Gil gil;
  PyObject* res = call_runtime(
      "release", Py_BuildValue("(L)", static_cast<long long>(engine)));
  if (res == nullptr) return PD_ERROR;
  Py_DECREF(res);
  return PD_OK;
}

}  // extern "C"
