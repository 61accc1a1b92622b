// Flat C API for FFI hosts (Lua/C#/C legacy clients).
//
// Capability parity with the reference's extern "C" surface
// (include/multiverso/c_api.h:14-54): float-only Array/Matrix tables plus
// init/shutdown/barrier/identity. Implementation embeds CPython and drives
// the PyTorch runtime (multiverso_tpu_torch) in-process, so an unmodified
// reference client links against libmultiverso_tpu.so and its tables land
// on the runtime's device (the GPU unless -device=cpu is passed).
#ifndef MULTIVERSO_TPU_C_API_H_
#define MULTIVERSO_TPU_C_API_H_

#ifdef __cplusplus
extern "C" {
#endif

typedef void* TableHandler;

// -- lifecycle --------------------------------------------------------------
void MV_Init(int* argc, char* argv[]);
void MV_ShutDown();
void MV_Barrier();

// -- identity ---------------------------------------------------------------
int MV_NumWorkers();
int MV_NumServers();
int MV_WorkerId();
int MV_ServerId();
int MV_Rank();
int MV_Size();

// -- flags ------------------------------------------------------------------
void MV_SetFlag(const char* name, const char* value);

// -- array table (float) ----------------------------------------------------
void MV_NewArrayTable(int size, TableHandler* out);
void MV_GetArrayTable(TableHandler handler, float* data, int size);
void MV_AddArrayTable(TableHandler handler, float* data, int size);
void MV_AddAsyncArrayTable(TableHandler handler, float* data, int size);

// -- matrix table (float) ---------------------------------------------------
void MV_NewMatrixTable(int num_row, int num_col, TableHandler* out);
void MV_GetMatrixTableAll(TableHandler handler, float* data, int size);
void MV_AddMatrixTableAll(TableHandler handler, float* data, int size);
void MV_AddAsyncMatrixTableAll(TableHandler handler, float* data, int size);
void MV_GetMatrixTableByRows(TableHandler handler, float* data, int size,
                             int* row_ids, int row_ids_n);
void MV_AddMatrixTableByRows(TableHandler handler, float* data, int size,
                             int* row_ids, int row_ids_n);
void MV_AddAsyncMatrixTableByRows(TableHandler handler, float* data, int size,
                                  int* row_ids, int row_ids_n);

#ifdef __cplusplus
}
#endif

#endif  // MULTIVERSO_TPU_C_API_H_
