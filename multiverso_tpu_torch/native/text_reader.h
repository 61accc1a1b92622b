// Native multithreaded libsvm reader — the analog of the
// reference's C++ sample readers (Applications/LogisticRegression/src/
// reader.cpp parsed libsvm-style lines on worker threads with async
// buffering). Exposed as a flat C ABI consumed by the Python framework
// via ctypes (models/logreg.py's load_libsvm uses it for plain local
// files and the Python parser for other stream schemes).
#ifndef MULTIVERSO_TPU_TEXT_READER_H_
#define MULTIVERSO_TPU_TEXT_READER_H_

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  long long n_rows;
  int max_nnz;
  int* labels;    // [n_rows]
  int* indices;   // [n_rows * max_nnz], -1 padded (the Python contract)
  float* values;  // [n_rows * max_nnz], 0 padded
} MVTRResult;

// Parse a libsvm file ("label k:v k:v ..." lines; blank lines skipped;
// a token without ":v" takes value 1.0; tokens beyond max_nnz ignored —
// byte-identical semantics to models/logreg.py::parse_libsvm_line).
// Returns 0 on success; nonzero on IO failure. The result's arrays are
// owned by the library: release with MVTR_FreeResult.
int MVTR_ParseLibsvmFile(const char* path, int max_nnz, MVTRResult* out);
void MVTR_FreeResult(MVTRResult* r);

#ifdef __cplusplus
}
#endif

#endif  // MULTIVERSO_TPU_TEXT_READER_H_
