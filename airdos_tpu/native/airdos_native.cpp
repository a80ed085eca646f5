// airdos_native — C++ host runtime for the map-bookkeeping hot paths.
//
// The reference's runtime is C++ end to end (ORB-SLAM2 fork); in this
// rebuild the device owns all dense math, and this module owns the
// integer/bit host work that Python is slow at:
//   - distinctive_descriptor: min-median-Hamming over a point's
//     observations (MapPoint::ComputeDistinctiveDescriptors,
//     reference src/MapPoint.cc:245-310)
//   - covisibility_counts: shared-observation counting for
//     KeyFrame::UpdateConnections (reference src/KeyFrame.cc:305)
//   - hamming_matrix_u8: CPU popcount fallback used by tests
//
// Built as a plain CPython extension (no pybind11 — see tools/build_native.sh).
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

inline int popcount64(uint64_t x) { return __builtin_popcountll(x); }

inline int hamming256(const uint8_t* a, const uint8_t* b) {
  uint64_t wa, wb;
  int d = 0;
  for (int i = 0; i < 4; ++i) {
    std::memcpy(&wa, a + 8 * i, 8);
    std::memcpy(&wb, b + 8 * i, 8);
    d += popcount64(wa ^ wb);
  }
  return d;
}

// distinctive_descriptor(descs: uint8[N, 32]) -> int index
PyObject* distinctive_descriptor(PyObject*, PyObject* args) {
  PyArrayObject* arr = nullptr;
  if (!PyArg_ParseTuple(args, "O!", &PyArray_Type, &arr)) return nullptr;
  if (PyArray_TYPE(arr) != NPY_UINT8 || PyArray_NDIM(arr) != 2 ||
      PyArray_DIM(arr, 1) != 32) {
    PyErr_SetString(PyExc_ValueError, "expected uint8[N, 32]");
    return nullptr;
  }
  PyArrayObject* c = (PyArrayObject*)PyArray_GETCONTIGUOUS(arr);
  const npy_intp n = PyArray_DIM(c, 0);
  const uint8_t* data = (const uint8_t*)PyArray_DATA(c);
  if (n == 0) {
    Py_DECREF(c);
    return PyLong_FromLong(-1);
  }
  std::vector<int> dist(n * n, 0);
  for (npy_intp i = 0; i < n; ++i)
    for (npy_intp j = i + 1; j < n; ++j) {
      int d = hamming256(data + 32 * i, data + 32 * j);
      dist[i * n + j] = d;
      dist[j * n + i] = d;
    }
  long best = 0;
  int best_median = INT32_MAX;
  std::vector<int> row(n);
  for (npy_intp i = 0; i < n; ++i) {
    std::copy(dist.begin() + i * n, dist.begin() + (i + 1) * n, row.begin());
    std::nth_element(row.begin(), row.begin() + (n - 1) / 2, row.end());
    int med = row[(n - 1) / 2];  // reference: vDists[0.5*(N-1)]
    if (med < best_median) {
      best_median = med;
      best = (long)i;
    }
  }
  Py_DECREF(c);
  return PyLong_FromLong(best);
}

// distinctive_descriptors_batch(descs: uint8[M, 32], offsets: int64[K+1])
//   -> int64[K] absolute row index of each point's winner (-1 if empty).
// One call refreshes every map point touched by a keyframe (the per-point
// Python->C transition was the dominant cost at ~1k points/KF).
PyObject* distinctive_descriptors_batch(PyObject*, PyObject* args) {
  PyArrayObject *pd = nullptr, *po = nullptr;
  if (!PyArg_ParseTuple(args, "O!O!", &PyArray_Type, &pd, &PyArray_Type, &po))
    return nullptr;
  if (PyArray_TYPE(pd) != NPY_UINT8 || PyArray_NDIM(pd) != 2 ||
      PyArray_DIM(pd, 1) != 32 || PyArray_TYPE(po) != NPY_INT64) {
    PyErr_SetString(PyExc_ValueError, "expected uint8[M,32], int64[K+1]");
    return nullptr;
  }
  PyArrayObject* cd = (PyArrayObject*)PyArray_GETCONTIGUOUS(pd);
  PyArrayObject* co = (PyArrayObject*)PyArray_GETCONTIGUOUS(po);
  const uint8_t* data = (const uint8_t*)PyArray_DATA(cd);
  const int64_t* off = (const int64_t*)PyArray_DATA(co);
  const npy_intp K = PyArray_SIZE(co) - 1;
  npy_intp dims[1] = {K};
  PyArrayObject* out = (PyArrayObject*)PyArray_SimpleNew(1, dims, NPY_INT64);
  int64_t* O = (int64_t*)PyArray_DATA(out);
  std::vector<int> dist;
  std::vector<int> row;
  for (npy_intp k = 0; k < K; ++k) {
    const int64_t lo = off[k], hi = off[k + 1];
    const int64_t n = hi - lo;
    if (n <= 0) {
      O[k] = -1;
      continue;
    }
    dist.assign((size_t)(n * n), 0);
    for (int64_t i = 0; i < n; ++i)
      for (int64_t j = i + 1; j < n; ++j) {
        int d = hamming256(data + 32 * (lo + i), data + 32 * (lo + j));
        dist[(size_t)(i * n + j)] = d;
        dist[(size_t)(j * n + i)] = d;
      }
    int64_t best = 0;
    int best_median = INT32_MAX;
    row.resize((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
      std::copy(dist.begin() + i * n, dist.begin() + (i + 1) * n, row.begin());
      std::nth_element(row.begin(), row.begin() + (n - 1) / 2, row.end());
      int med = row[(size_t)((n - 1) / 2)];  // reference: vDists[0.5*(N-1)]
      if (med < best_median) {
        best_median = med;
        best = i;
      }
    }
    O[k] = lo + best;
  }
  Py_DECREF(cd);
  Py_DECREF(co);
  return (PyObject*)out;
}

// covisibility_counts(point_kf_lists: list[ndarray int64], self_id: int)
//   -> dict {kf_id: count}
// Each ndarray holds the KF ids observing one of the query KF's points.
PyObject* covisibility_counts(PyObject*, PyObject* args) {
  PyObject* lists = nullptr;
  long self_id = 0;
  if (!PyArg_ParseTuple(args, "Ol", &lists, &self_id)) return nullptr;
  if (!PyList_Check(lists)) {
    PyErr_SetString(PyExc_TypeError, "expected a list of int64 arrays");
    return nullptr;
  }
  std::unordered_map<long, long> counts;
  const Py_ssize_t m = PyList_GET_SIZE(lists);
  for (Py_ssize_t k = 0; k < m; ++k) {
    PyObject* o = PyList_GET_ITEM(lists, k);
    PyArrayObject* a = (PyArrayObject*)o;
    if (!PyArray_Check(o) || PyArray_TYPE(a) != NPY_INT64) {
      PyErr_SetString(PyExc_TypeError, "entries must be int64 ndarrays");
      return nullptr;
    }
    PyArrayObject* c = (PyArrayObject*)PyArray_GETCONTIGUOUS(a);
    const int64_t* ids = (const int64_t*)PyArray_DATA(c);
    const npy_intp n = PyArray_SIZE(c);
    for (npy_intp i = 0; i < n; ++i)
      if (ids[i] != self_id) counts[ids[i]] += 1;
    Py_DECREF(c);
  }
  PyObject* out = PyDict_New();
  for (auto& kv : counts) {
    PyObject* key = PyLong_FromLong(kv.first);
    PyObject* val = PyLong_FromLong(kv.second);
    PyDict_SetItem(out, key, val);
    Py_DECREF(key);
    Py_DECREF(val);
  }
  return out;
}

// hamming_matrix_u8(a: uint8[N, 32], b: uint8[M, 32]) -> int32[N, M]
PyObject* hamming_matrix_u8(PyObject*, PyObject* args) {
  PyArrayObject *pa = nullptr, *pb = nullptr;
  if (!PyArg_ParseTuple(args, "O!O!", &PyArray_Type, &pa, &PyArray_Type, &pb))
    return nullptr;
  PyArrayObject* ca = (PyArrayObject*)PyArray_GETCONTIGUOUS(pa);
  PyArrayObject* cb = (PyArrayObject*)PyArray_GETCONTIGUOUS(pb);
  const npy_intp n = PyArray_DIM(ca, 0), m = PyArray_DIM(cb, 0);
  npy_intp dims[2] = {n, m};
  PyArrayObject* out = (PyArrayObject*)PyArray_SimpleNew(2, dims, NPY_INT32);
  const uint8_t* A = (const uint8_t*)PyArray_DATA(ca);
  const uint8_t* B = (const uint8_t*)PyArray_DATA(cb);
  int32_t* O = (int32_t*)PyArray_DATA(out);
  for (npy_intp i = 0; i < n; ++i)
    for (npy_intp j = 0; j < m; ++j)
      O[i * m + j] = hamming256(A + 32 * i, B + 32 * j);
  Py_DECREF(ca);
  Py_DECREF(cb);
  return (PyObject*)out;
}

PyMethodDef methods[] = {
    {"distinctive_descriptor", distinctive_descriptor, METH_VARARGS,
     "min-median-Hamming descriptor index over uint8[N,32]"},
    {"distinctive_descriptors_batch", distinctive_descriptors_batch,
     METH_VARARGS,
     "batched min-median-Hamming: uint8[M,32] + int64[K+1] offsets -> "
     "int64[K] absolute winner rows"},
    {"covisibility_counts", covisibility_counts, METH_VARARGS,
     "count shared-KF observations from per-point KF-id arrays"},
    {"hamming_matrix_u8", hamming_matrix_u8, METH_VARARGS,
     "all-pairs Hamming distances between uint8[N,32] descriptor sets"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "airdos_native",
                                "native host runtime for airdos_tpu", -1,
                                methods};

}  // namespace

PyMODINIT_FUNC PyInit_airdos_native(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
