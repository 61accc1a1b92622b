/* End-to-end C client of libmultiverso_tpu.so — the FFI parity proof
 * (the port's build: the tables land on the runtime's device; pass
 * -device=cpu to keep them on the host).
 *
 * Mirrors the reference's MPI end-to-end tests (Test/test_array_table.cpp,
 * test_matrix_table.cpp) driven purely through the flat C API: init, array
 * add/get, matrix whole and row ops, async add + barrier, identity queries.
 * Exit code 0 = all assertions passed.
 */
#include <stdio.h>
#include <stdlib.h>
#include <math.h>

#include "c_api.h"

#define CHECK(cond)                                                     \
  do {                                                                  \
    if (!(cond)) {                                                      \
      fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__, __LINE__, \
              #cond);                                                   \
      exit(1);                                                          \
    }                                                                   \
  } while (0)

int main(int argc, char* argv[]) {
  MV_Init(&argc, argv);
  CHECK(MV_NumWorkers() >= 1);
  CHECK(MV_WorkerId() >= 0);
  CHECK(MV_NumServers() >= 1);
  CHECK(MV_Rank() == 0);

  /* array table: two adds then get */
  TableHandler array;
  MV_NewArrayTable(64, &array);
  float delta[64], out[64];
  for (int i = 0; i < 64; ++i) delta[i] = (float)i;
  MV_AddArrayTable(array, delta, 64);
  MV_AddArrayTable(array, delta, 64);
  MV_GetArrayTable(array, out, 64);
  for (int i = 0; i < 64; ++i) CHECK(fabsf(out[i] - 2.0f * i) < 1e-5f);

  /* async add then barrier-ish get */
  MV_AddAsyncArrayTable(array, delta, 64);
  MV_Barrier();
  MV_GetArrayTable(array, out, 64);
  for (int i = 0; i < 64; ++i) CHECK(fabsf(out[i] - 3.0f * i) < 1e-4f);

  /* matrix table: whole add/get + row ops */
  TableHandler matrix;
  MV_NewMatrixTable(10, 4, &matrix);
  float mdelta[40], mout[40];
  for (int i = 0; i < 40; ++i) mdelta[i] = 1.0f;
  MV_AddMatrixTableAll(matrix, mdelta, 40);
  MV_GetMatrixTableAll(matrix, mout, 40);
  for (int i = 0; i < 40; ++i) CHECK(fabsf(mout[i] - 1.0f) < 1e-5f);

  int rows[2] = {3, 7};
  float rdelta[8] = {5, 5, 5, 5, 9, 9, 9, 9};
  float rout[8];
  MV_AddMatrixTableByRows(matrix, rdelta, 8, rows, 2);
  MV_GetMatrixTableByRows(matrix, rout, 8, rows, 2);
  CHECK(fabsf(rout[0] - 6.0f) < 1e-5f);
  CHECK(fabsf(rout[4] - 10.0f) < 1e-5f);

  MV_ShutDown();
  printf("c_api smoke test passed\n");
  return 0;
}
