// C API implementation: embeds CPython and drives the multiverso_tpu_torch
// runtime (the port of multiverso_tpu/native/c_api.cpp; one import differs).
//
// Design (vs the reference src/c_api.cpp which called the C++ core
// directly): the core is the PyTorch runtime, so the shim owns an embedded
// interpreter. All marshalling happens through multiverso_tpu_torch.c_bridge
// — the C side only moves raw pointers wrapped as memoryviews, keeping the
// tensor logic in Python. Every entry point grabs the GIL, so FFI hosts may
// call from any thread.
//
// The library links no libpython: a Python process that loads it with
// ctypes already holds the interpreter's symbols, and a C host links
// libpython itself (python3-config --ldflags --embed).

#include "c_api.h"

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <string>
#include <vector>

namespace {

PyObject* g_bridge = nullptr;  // multiverso_tpu_torch.c_bridge module

void FatalPython(const char* where) {
  std::fprintf(stderr, "[multiverso_tpu_torch c_api] python error in %s:\n", where);
  PyErr_Print();
  std::abort();
}

void EnsureInterpreter() {
  static std::once_flag once;
  std::call_once(once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // Py_InitializeEx leaves the calling thread holding the GIL; release
      // it so other host threads' PyGILState_Ensure can proceed while this
      // thread runs plain C code. Every entry point re-acquires via Gil.
      // The interpreter is deliberately never finalized: tearing down an
      // embedded CPython with torch and CUDA loaded is unsafe, and hosts that
      // MV_ShutDown may keep running.
      PyEval_SaveThread();
    }
  });
}

// RAII GIL hold valid for both embedded and host-owned interpreters.
// Bootstraps the embedded interpreter first: FFI hosts legitimately call
// flag/identity entry points BEFORE MV_Init (the Lua binding's
// mv.set_flag), and PyGILState_Ensure on an uninitialized interpreter is
// a crash (found by native/test_lua_ffi.c).
class Gil {
 public:
  Gil() {
    EnsureInterpreter();
    state_ = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

PyObject* Bridge() {
  if (g_bridge == nullptr) {
    g_bridge = PyImport_ImportModule("multiverso_tpu_torch.c_bridge");
    if (g_bridge == nullptr) FatalPython("import multiverso_tpu_torch.c_bridge");
  }
  return g_bridge;
}

// Call bridge.<name>(args...) and return the result (new ref) or abort.
PyObject* Call(const char* name, PyObject* args) {
  PyObject* fn = PyObject_GetAttrString(Bridge(), name);
  if (fn == nullptr) FatalPython(name);
  PyObject* result = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_XDECREF(args);
  if (result == nullptr) FatalPython(name);
  return result;
}

long CallLong(const char* name) {
  Gil gil;
  PyObject* result = Call(name, nullptr);
  long value = PyLong_AsLong(result);
  Py_DECREF(result);
  return value;
}

PyObject* FloatView(float* data, int size, bool writable) {
  return PyMemoryView_FromMemory(reinterpret_cast<char*>(data),
                                 static_cast<Py_ssize_t>(size) * sizeof(float),
                                 writable ? PyBUF_WRITE : PyBUF_READ);
}

PyObject* IntView(int* data, int size) {
  return PyMemoryView_FromMemory(reinterpret_cast<char*>(data),
                                 static_cast<Py_ssize_t>(size) * sizeof(int),
                                 PyBUF_READ);
}

}  // namespace

extern "C" {

void MV_Init(int* argc, char* argv[]) {
  EnsureInterpreter();
  Gil gil;
  PyObject* list = PyList_New(0);
  int n = (argc != nullptr) ? *argc : 0;
  for (int i = 0; i < n; ++i) {
    PyObject* s = PyUnicode_FromString(argv[i]);
    PyList_Append(list, s);
    Py_DECREF(s);
  }
  PyObject* result = Call("init", Py_BuildValue("(O)", list));
  Py_DECREF(list);
  Py_DECREF(result);
}

void MV_ShutDown() {
  Gil gil;
  Py_DECREF(Call("shutdown", nullptr));
  Py_XDECREF(g_bridge);
  g_bridge = nullptr;  // a later MV_Init re-imports the bridge
}

void MV_Barrier() {
  Gil gil;
  Py_DECREF(Call("barrier", nullptr));
}

int MV_NumWorkers() { return static_cast<int>(CallLong("num_workers")); }
int MV_NumServers() { return static_cast<int>(CallLong("num_servers")); }
int MV_WorkerId() { return static_cast<int>(CallLong("worker_id")); }
int MV_ServerId() { return static_cast<int>(CallLong("server_id")); }
int MV_Rank() { return static_cast<int>(CallLong("rank")); }
int MV_Size() { return static_cast<int>(CallLong("size")); }

void MV_SetFlag(const char* name, const char* value) {
  Gil gil;
  Py_DECREF(Call("set_flag", Py_BuildValue("(ss)", name, value)));
}

// -- array table ------------------------------------------------------------

void MV_NewArrayTable(int size, TableHandler* out) {
  Gil gil;
  PyObject* result = Call("new_array_table", Py_BuildValue("(i)", size));
  *out = reinterpret_cast<TableHandler>(PyLong_AsLong(result));
  Py_DECREF(result);
}

void MV_GetArrayTable(TableHandler handler, float* data, int size) {
  Gil gil;
  PyObject* view = FloatView(data, size, /*writable=*/true);
  Py_DECREF(Call("array_get", Py_BuildValue(
      "(lOi)", reinterpret_cast<long>(handler), view, size)));
  Py_DECREF(view);
}

static void ArrayAdd(TableHandler handler, float* data, int size, int async_) {
  Gil gil;
  PyObject* view = FloatView(data, size, /*writable=*/false);
  Py_DECREF(Call("array_add", Py_BuildValue(
      "(lOii)", reinterpret_cast<long>(handler), view, size, async_)));
  Py_DECREF(view);
}

void MV_AddArrayTable(TableHandler handler, float* data, int size) {
  ArrayAdd(handler, data, size, 0);
}

void MV_AddAsyncArrayTable(TableHandler handler, float* data, int size) {
  ArrayAdd(handler, data, size, 1);
}

// -- matrix table -----------------------------------------------------------

void MV_NewMatrixTable(int num_row, int num_col, TableHandler* out) {
  Gil gil;
  PyObject* result =
      Call("new_matrix_table", Py_BuildValue("(ii)", num_row, num_col));
  *out = reinterpret_cast<TableHandler>(PyLong_AsLong(result));
  Py_DECREF(result);
}

void MV_GetMatrixTableAll(TableHandler handler, float* data, int size) {
  Gil gil;
  PyObject* view = FloatView(data, size, /*writable=*/true);
  Py_DECREF(Call("matrix_get_all", Py_BuildValue(
      "(lOi)", reinterpret_cast<long>(handler), view, size)));
  Py_DECREF(view);
}

static void MatrixAddAll(TableHandler handler, float* data, int size,
                         int async_) {
  Gil gil;
  PyObject* view = FloatView(data, size, /*writable=*/false);
  Py_DECREF(Call("matrix_add_all", Py_BuildValue(
      "(lOii)", reinterpret_cast<long>(handler), view, size, async_)));
  Py_DECREF(view);
}

void MV_AddMatrixTableAll(TableHandler handler, float* data, int size) {
  MatrixAddAll(handler, data, size, 0);
}

void MV_AddAsyncMatrixTableAll(TableHandler handler, float* data, int size) {
  MatrixAddAll(handler, data, size, 1);
}

void MV_GetMatrixTableByRows(TableHandler handler, float* data, int size,
                             int* row_ids, int row_ids_n) {
  Gil gil;
  PyObject* view = FloatView(data, size, /*writable=*/true);
  PyObject* ids = IntView(row_ids, row_ids_n);
  Py_DECREF(Call("matrix_get_rows", Py_BuildValue(
      "(lOiOi)", reinterpret_cast<long>(handler), view, size, ids,
      row_ids_n)));
  Py_DECREF(ids);
  Py_DECREF(view);
}

static void MatrixAddRows(TableHandler handler, float* data, int size,
                          int* row_ids, int row_ids_n, int async_) {
  Gil gil;
  PyObject* view = FloatView(data, size, /*writable=*/false);
  PyObject* ids = IntView(row_ids, row_ids_n);
  Py_DECREF(Call("matrix_add_rows", Py_BuildValue(
      "(lOiOii)", reinterpret_cast<long>(handler), view, size, ids, row_ids_n,
      async_)));
  Py_DECREF(ids);
  Py_DECREF(view);
}

void MV_AddMatrixTableByRows(TableHandler handler, float* data, int size,
                             int* row_ids, int row_ids_n) {
  MatrixAddRows(handler, data, size, row_ids, row_ids_n, 0);
}

void MV_AddAsyncMatrixTableByRows(TableHandler handler, float* data, int size,
                                  int* row_ids, int row_ids_n) {
  MatrixAddRows(handler, data, size, row_ids, row_ids_n, 1);
}

}  // extern "C"
