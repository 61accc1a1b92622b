/* Lua-FFI replay harness: executes the EXACT call sequence
 * bindings/lua/multiverso.lua makes against libmultiverso_tpu.so, the way
 * LuaJIT's FFI would make it — dlopen + dlsym (ffi.load resolves symbols
 * dynamically, never at link time), per-call heap buffers (ffi.new
 * allocates zero-initialized cdata per call), NULL-terminated argv with a
 * heap char buffer per string (mv.init), int[] row-id arrays built from
 * Lua tables (MatrixTableHandler:get/add), and the async-by-default add
 * dispatch (opts.sync selects the blocking spelling).
 *
 * On top of the marshalling replay it runs the reference Lua binding's
 * end-to-end workload shape — an XOR net trained with its parameters
 * living in an ArrayTable (capability match for
 * the reference's binding/lua/xor.lua, not a translation): every
 * iteration Gets the parameters over the FFI, computes gradients in
 * plain C, and Adds the scaled delta back. Exit 0 = marshalling AND
 * learning both verified.
 *
 * Each section is annotated with the multiverso.lua lines it replays so
 * the harness fails if the binding's sequence drifts from the C ABI.
 *
 * The port's copy hands its own argv to mv.init (so a run may say
 * -device=cpu); the tables land on the runtime's device.
 */
#include <dlfcn.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define CHECK(cond)                                                     \
  do {                                                                  \
    if (!(cond)) {                                                      \
      fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__, __LINE__, \
              #cond);                                                   \
      exit(1);                                                          \
    }                                                                   \
  } while (0)

typedef void* TableHandler;

/* the cdef'd surface (multiverso.lua:22-48), resolved like ffi.load */
static void (*MV_Init)(int*, char*[]);
static void (*MV_ShutDown)(void);
static void (*MV_Barrier)(void);
static int (*MV_NumWorkers)(void);
static int (*MV_NumServers)(void);
static int (*MV_WorkerId)(void);
static int (*MV_ServerId)(void);
static int (*MV_Rank)(void);
static int (*MV_Size)(void);
static void (*MV_SetFlag)(const char*, const char*);
static void (*MV_NewArrayTable)(int, TableHandler*);
static void (*MV_GetArrayTable)(TableHandler, float*, int);
static void (*MV_AddArrayTable)(TableHandler, float*, int);
static void (*MV_AddAsyncArrayTable)(TableHandler, float*, int);
static void (*MV_NewMatrixTable)(int, int, TableHandler*);
static void (*MV_GetMatrixTableAll)(TableHandler, float*, int);
static void (*MV_AddMatrixTableAll)(TableHandler, float*, int);
static void (*MV_AddAsyncMatrixTableAll)(TableHandler, float*, int);
static void (*MV_GetMatrixTableByRows)(TableHandler, float*, int, int*, int);
static void (*MV_AddMatrixTableByRows)(TableHandler, float*, int, int*, int);
static void (*MV_AddAsyncMatrixTableByRows)(TableHandler, float*, int, int*,
                                            int);

static void* must_sym(void* lib, const char* name) {
  void* p = dlsym(lib, name);
  if (!p) {
    fprintf(stderr, "dlsym(%s) failed: %s\n", name, dlerror());
    exit(1);
  }
  return p;
}

/* mv.init (multiverso.lua:56-69): argc as int[1], argv as a
 * zero-initialized char*[#args+1] (ffi.new zero-fills -> NULL
 * terminator), each string copied into its own heap char buffer. */
static void lua_init(int nargs, const char** args) {
  int* argc = calloc(1, sizeof(int));
  char** argv = calloc((size_t)nargs + 1, sizeof(char*));
  *argc = nargs;
  for (int i = 0; i < nargs; ++i) {
    size_t len = strlen(args[i]);
    char* buf = calloc(len + 1, 1); /* ffi.new('char[?]', #a+1, a) */
    memcpy(buf, args[i], len);
    argv[i] = buf;
  }
  MV_Init(argc, argv);
  for (int i = 0; i < nargs; ++i) free(argv[i]);
  free(argv);
  free(argc);
}

/* -- XOR workload (capability shape of binding/lua/xor.lua) ------------- */

#define NH 4 /* hidden units: wide enough that random init escapes the
               * OR/AND local minima a 2-unit XOR net falls into */
#define NPARAM (NH * 2 + NH + NH + 1) /* w1(2xNH) b1(NH) w2(NH) b2(1) */

static float fwd(const float* p, const float* x, float* h) {
  const float* w1 = p;            /* [NH][2] */
  const float* b1 = p + 2 * NH;   /* [NH] */
  const float* w2 = b1 + NH;      /* [NH] */
  float b2 = w2[NH];
  float z = b2;
  for (int j = 0; j < NH; ++j) {
    h[j] = tanhf(w1[2 * j] * x[0] + w1[2 * j + 1] * x[1] + b1[j]);
    z += w2[j] * h[j];
  }
  return 1.0f / (1.0f + expf(-z));
}

static void xor_grad(const float* p, float* g) {
  static const float X[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
  static const float Y[4] = {0, 1, 1, 0};
  const float* w2 = p + 3 * NH;
  memset(g, 0, NPARAM * sizeof(float));
  for (int s = 0; s < 4; ++s) {
    float h[NH];
    float y = fwd(p, X[s], h);
    float dz = y - Y[s]; /* d(BCE)/dz for sigmoid output */
    for (int j = 0; j < NH; ++j) {
      float dh = dz * w2[j] * (1 - h[j] * h[j]);
      g[2 * j] += dh * X[s][0];
      g[2 * j + 1] += dh * X[s][1];
      g[2 * NH + j] += dh;       /* b1 */
      g[3 * NH + j] += dz * h[j]; /* w2 */
    }
    g[4 * NH] += dz; /* b2 */
  }
}

int main(int argc, char* argv[]) {
  /* ffi.load('multiverso_tpu') -> the .so next to this binary */
  void* lib = dlopen("./libmultiverso_tpu.so", RTLD_NOW | RTLD_GLOBAL);
  if (!lib) {
    fprintf(stderr, "dlopen failed: %s\n", dlerror());
    return 1;
  }
  MV_Init = must_sym(lib, "MV_Init");
  MV_ShutDown = must_sym(lib, "MV_ShutDown");
  MV_Barrier = must_sym(lib, "MV_Barrier");
  MV_NumWorkers = must_sym(lib, "MV_NumWorkers");
  MV_NumServers = must_sym(lib, "MV_NumServers");
  MV_WorkerId = must_sym(lib, "MV_WorkerId");
  MV_ServerId = must_sym(lib, "MV_ServerId");
  MV_Rank = must_sym(lib, "MV_Rank");
  MV_Size = must_sym(lib, "MV_Size");
  MV_SetFlag = must_sym(lib, "MV_SetFlag");
  MV_NewArrayTable = must_sym(lib, "MV_NewArrayTable");
  MV_GetArrayTable = must_sym(lib, "MV_GetArrayTable");
  MV_AddArrayTable = must_sym(lib, "MV_AddArrayTable");
  MV_AddAsyncArrayTable = must_sym(lib, "MV_AddAsyncArrayTable");
  MV_NewMatrixTable = must_sym(lib, "MV_NewMatrixTable");
  MV_GetMatrixTableAll = must_sym(lib, "MV_GetMatrixTableAll");
  MV_AddMatrixTableAll = must_sym(lib, "MV_AddMatrixTableAll");
  MV_AddAsyncMatrixTableAll = must_sym(lib, "MV_AddAsyncMatrixTableAll");
  MV_GetMatrixTableByRows = must_sym(lib, "MV_GetMatrixTableByRows");
  MV_AddMatrixTableByRows = must_sym(lib, "MV_AddMatrixTableByRows");
  MV_AddAsyncMatrixTableByRows = must_sym(lib, "MV_AddAsyncMatrixTableByRows");

  /* mv.set_flag before init (multiverso.lua:79, tostring coercion) */
  MV_SetFlag("local_workers", "1");
  lua_init(argc - 1, (const char**)(argv + 1)); /* mv.init(arg) */
  CHECK(MV_NumWorkers() >= 1);
  CHECK(MV_NumServers() >= 1);
  CHECK(MV_WorkerId() >= 0);
  CHECK(MV_ServerId() == 0); /* default role: this process is the server */
  CHECK(MV_Rank() == 0);
  CHECK(MV_Size() == 1);

  /* ArrayTableHandler:new(size) (multiverso.lua:107-113): handler out
   * param as TableHandler[1] */
  TableHandler* out = calloc(1, sizeof(TableHandler));
  MV_NewArrayTable(NPARAM, out);
  TableHandler params_tbl = out[0];
  free(out);

  /* seed the parameters once (deterministic srand: xor.lua seeded torch) */
  srand(7);
  float init[NPARAM];
  for (int i = 0; i < NPARAM; ++i)
    init[i] = ((float)rand() / RAND_MAX - 0.5f) * 2.0f;
  MV_AddArrayTable(params_tbl, init, NPARAM); /* opts.sync=true spelling */

  /* training loop: tbl:get() -> grads in C -> tbl:add(delta) async, the
   * xor.lua epoch shape; per-iteration heap buffers like ffi.new */
  const float lr = 0.8f;
  for (int it = 0; it < 600; ++it) {
    float* buf = calloc(NPARAM, sizeof(float)); /* ffi.new('float[?]') */
    MV_GetArrayTable(params_tbl, buf, NPARAM);
    float g[NPARAM], delta[NPARAM];
    xor_grad(buf, g);
    for (int i = 0; i < NPARAM; ++i) delta[i] = -lr * g[i];
    if (it % 2 == 0)
      MV_AddArrayTable(params_tbl, delta, NPARAM); /* {sync=true} */
    else
      MV_AddAsyncArrayTable(params_tbl, delta, NPARAM); /* default */
    free(buf);
  }
  MV_Barrier(); /* mv.barrier() drains the async tail (xor.lua epoch end) */

  float trained[NPARAM];
  MV_GetArrayTable(params_tbl, trained, NPARAM);
  static const float X[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
  static const float Y[4] = {0, 1, 1, 0};
  for (int s = 0; s < 4; ++s) {
    float h[NH];
    float y = fwd(trained, X[s], h);
    fprintf(stderr, "xor(%g,%g) = %.3f want %g\n", X[s][0], X[s][1], y, Y[s]);
    CHECK(fabsf(y - Y[s]) < 0.35f);
  }

  /* MatrixTableHandler replay (multiverso.lua:136-176): whole get/add,
   * row-subset get/add with int[] ids from a Lua table, async rows */
  out = calloc(1, sizeof(TableHandler));
  MV_NewMatrixTable(6, 3, out);
  TableHandler mat = out[0];
  free(out);

  float* mdelta = calloc(18, sizeof(float));
  for (int i = 0; i < 18; ++i) mdelta[i] = 0.5f;
  MV_AddMatrixTableAll(mat, mdelta, 18); /* {sync=true} */
  float* mout = calloc(18, sizeof(float));
  MV_GetMatrixTableAll(mat, mout, 18);
  for (int i = 0; i < 18; ++i) CHECK(fabsf(mout[i] - 0.5f) < 1e-5f);
  free(mdelta);
  free(mout);

  int* ids = calloc(2, sizeof(int)); /* ffi.new('int[?]', #row_ids, ...) */
  ids[0] = 1;
  ids[1] = 4;
  float* rdelta = calloc(6, sizeof(float));
  for (int i = 0; i < 6; ++i) rdelta[i] = (float)(i + 1);
  MV_AddMatrixTableByRows(mat, rdelta, 6, ids, 2);
  MV_AddAsyncMatrixTableByRows(mat, rdelta, 6, ids, 2);
  MV_Barrier();
  float* rout = calloc(6, sizeof(float));
  MV_GetMatrixTableByRows(mat, rout, 6, ids, 2);
  for (int i = 0; i < 6; ++i)
    CHECK(fabsf(rout[i] - (0.5f + 2.0f * (i + 1))) < 1e-4f);
  free(ids);
  free(rdelta);
  free(rout);

  /* async whole-matrix add (MatrixTableHandler:add default spelling) */
  float* adelta = calloc(18, sizeof(float));
  for (int i = 0; i < 18; ++i) adelta[i] = 0.25f;
  MV_AddAsyncMatrixTableAll(mat, adelta, 18);
  MV_Barrier(); /* drain the async tail before reading */
  float* aout = calloc(18, sizeof(float));
  MV_GetMatrixTableAll(mat, aout, 18);
  CHECK(fabsf(aout[0] - 0.75f) < 1e-4f); /* 0.5 (sync all) + 0.25 */
  free(adelta);
  free(aout);

  MV_ShutDown();
  printf("lua ffi replay passed\n");
  return 0;
}
