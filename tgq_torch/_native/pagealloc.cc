// tgq_torch native serving runtime: page allocator + page-table manager
// (a copy of tgq/_native/pagealloc.cc under its own module name).
//
// The serving engine's host-side hot path is per-tick bookkeeping:
// extending slot lengths, allocating/freeing pages, and materializing
// the device-bound page-table / length arrays.  This is the native
// backend of tgq_torch.serve.kv_cache.PageTable (semantics identical to
// the pure-Python backend and to the JAX package's allocator —
// tests/test_torch_native.py checks equivalence on randomized op
// sequences).
//
// CPython C API (no pybind11 in this image).  Buffers are plain C
// arrays; device_tables() fills caller-provided NumPy buffers through
// the buffer protocol, so a tick does no Python-level list work at all.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct PageAllocObject {
  PyObject_HEAD
  int32_t num_pages;
  int32_t page_size;
  int32_t max_slots;
  int32_t max_pages_per_slot;
  std::vector<int32_t>* free_list;   // LIFO stack
  std::vector<int32_t>* table;       // max_slots * max_pages_per_slot
  std::vector<int32_t>* lens;        // max_slots
};

int pages_needed(const PageAllocObject* self, int32_t n_tokens) {
  return (n_tokens + self->page_size - 1) / self->page_size;
}

int PageAlloc_init(PageAllocObject* self, PyObject* args, PyObject* kwds) {
  static const char* kwlist[] = {"num_pages", "page_size", "max_slots",
                                 "max_pages_per_slot", nullptr};
  if (!PyArg_ParseTupleAndKeywords(
          args, kwds, "iiii", const_cast<char**>(kwlist), &self->num_pages,
          &self->page_size, &self->max_slots, &self->max_pages_per_slot))
    return -1;
  self->free_list = new std::vector<int32_t>();
  // page 0 reserved as the scratch page (see tgq_torch.serve.kv_cache)
  self->free_list->reserve(self->num_pages);
  for (int32_t p = self->num_pages - 1; p >= 1; --p) self->free_list->push_back(p);
  self->table = new std::vector<int32_t>(
      (size_t)self->max_slots * self->max_pages_per_slot, -1);
  self->lens = new std::vector<int32_t>(self->max_slots, 0);
  return 0;
}

void PageAlloc_dealloc(PageAllocObject* self) {
  delete self->free_list;
  delete self->table;
  delete self->lens;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

PyObject* PageAlloc_can_alloc(PageAllocObject* self, PyObject* arg) {
  long n = PyLong_AsLong(arg);
  if (n == -1 && PyErr_Occurred()) return nullptr;
  return PyBool_FromLong((long)self->free_list->size() >=
                         pages_needed(self, (int32_t)n));
}

PyObject* PageAlloc_alloc_slot(PageAllocObject* self, PyObject* args) {
  int slot, n_tokens;
  if (!PyArg_ParseTuple(args, "ii", &slot, &n_tokens)) return nullptr;
  int need = pages_needed(self, n_tokens);
  if (need > self->max_pages_per_slot) {
    PyErr_SetString(PyExc_ValueError, "prompt exceeds max_pages_per_slot");
    return nullptr;
  }
  if ((int)self->free_list->size() < need) {
    PyErr_SetString(PyExc_RuntimeError, "page pool exhausted");
    return nullptr;
  }
  int32_t* row = self->table->data() + (size_t)slot * self->max_pages_per_slot;
  for (int i = 0; i < need; ++i) {
    row[i] = self->free_list->back();
    self->free_list->pop_back();
  }
  (*self->lens)[slot] = n_tokens;
  // return the allocated pages as a tuple (prefill needs them)
  PyObject* out = PyTuple_New(need);
  for (int i = 0; i < need; ++i)
    PyTuple_SET_ITEM(out, i, PyLong_FromLong(row[i]));
  return out;
}

PyObject* PageAlloc_extend(PageAllocObject* self, PyObject* args) {
  int slot, n_new = 1;
  if (!PyArg_ParseTuple(args, "i|i", &slot, &n_new)) return nullptr;
  int32_t old_len = (*self->lens)[slot];
  int32_t new_len = old_len + n_new;
  int have = old_len ? pages_needed(self, old_len) : 0;
  int need = pages_needed(self, new_len);
  if (need > self->max_pages_per_slot) {
    PyErr_SetString(PyExc_RuntimeError, "slot exceeds max_pages_per_slot");
    return nullptr;
  }
  int32_t* row = self->table->data() + (size_t)slot * self->max_pages_per_slot;
  for (int i = have; i < need; ++i) {
    if (self->free_list->empty()) {
      PyErr_SetString(PyExc_RuntimeError, "page pool exhausted");
      return nullptr;
    }
    row[i] = self->free_list->back();
    self->free_list->pop_back();
  }
  (*self->lens)[slot] = new_len;
  Py_RETURN_NONE;
}

PyObject* PageAlloc_free_slot(PageAllocObject* self, PyObject* arg) {
  long slot = PyLong_AsLong(arg);
  if (slot == -1 && PyErr_Occurred()) return nullptr;
  int32_t* row = self->table->data() + (size_t)slot * self->max_pages_per_slot;
  for (int i = 0; i < self->max_pages_per_slot; ++i) {
    if (row[i] >= 0) {
      self->free_list->push_back(row[i]);
      row[i] = -1;
    }
  }
  (*self->lens)[slot] = 0;
  Py_RETURN_NONE;
}

// detach_slot(slot): clear the slot's mapping WITHOUT returning pages to
// the free list — used when an in-flight speculative decode chunk may
// still write to them.  Returns the detached pages as a tuple; the
// caller releases them via release_pages() once the chunk completes.
PyObject* PageAlloc_detach_slot(PageAllocObject* self, PyObject* arg) {
  long slot = PyLong_AsLong(arg);
  if (slot == -1 && PyErr_Occurred()) return nullptr;
  int32_t* row = self->table->data() + (size_t)slot * self->max_pages_per_slot;
  int n = 0;
  while (n < self->max_pages_per_slot && row[n] >= 0) ++n;
  PyObject* out = PyTuple_New(n);
  for (int i = 0; i < n; ++i) {
    PyTuple_SET_ITEM(out, i, PyLong_FromLong(row[i]));
    row[i] = -1;
  }
  (*self->lens)[slot] = 0;
  return out;
}

// release_pages(pages): return previously-detached pages to the free list
PyObject* PageAlloc_release_pages(PageAllocObject* self, PyObject* arg) {
  PyObject* seq = PySequence_Fast(arg, "release_pages expects a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  for (Py_ssize_t i = 0; i < n; ++i) {
    long p = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, i));
    if (p == -1 && PyErr_Occurred()) {
      Py_DECREF(seq);
      return nullptr;
    }
    self->free_list->push_back((int32_t)p);
  }
  Py_DECREF(seq);
  Py_RETURN_NONE;
}

// fill_tables(table_buf, lens_buf): write the device-bound arrays into
// caller-provided contiguous int32 buffers (negative entries clamp to 0)
PyObject* PageAlloc_fill_tables(PageAllocObject* self, PyObject* args) {
  Py_buffer tbuf, lbuf;
  if (!PyArg_ParseTuple(args, "w*w*", &tbuf, &lbuf)) return nullptr;
  size_t tn = (size_t)self->max_slots * self->max_pages_per_slot;
  if ((size_t)tbuf.len < tn * 4 || (size_t)lbuf.len < (size_t)self->max_slots * 4) {
    PyBuffer_Release(&tbuf);
    PyBuffer_Release(&lbuf);
    PyErr_SetString(PyExc_ValueError, "buffer too small");
    return nullptr;
  }
  int32_t* t = (int32_t*)tbuf.buf;
  const int32_t* src = self->table->data();
  for (size_t i = 0; i < tn; ++i) t[i] = src[i] < 0 ? 0 : src[i];
  std::memcpy(lbuf.buf, self->lens->data(), (size_t)self->max_slots * 4);
  PyBuffer_Release(&tbuf);
  PyBuffer_Release(&lbuf);
  Py_RETURN_NONE;
}

PyObject* PageAlloc_get_len(PageAllocObject* self, PyObject* arg) {
  long slot = PyLong_AsLong(arg);
  if (slot == -1 && PyErr_Occurred()) return nullptr;
  return PyLong_FromLong((*self->lens)[slot]);
}

PyObject* PageAlloc_num_free(PageAllocObject* self, PyObject*) {
  return PyLong_FromSize_t(self->free_list->size());
}

PyObject* PageAlloc_slot_pages(PageAllocObject* self, PyObject* arg) {
  long slot = PyLong_AsLong(arg);
  if (slot == -1 && PyErr_Occurred()) return nullptr;
  const int32_t* row =
      self->table->data() + (size_t)slot * self->max_pages_per_slot;
  int n = 0;
  while (n < self->max_pages_per_slot && row[n] >= 0) ++n;
  PyObject* out = PyTuple_New(n);
  for (int i = 0; i < n; ++i)
    PyTuple_SET_ITEM(out, i, PyLong_FromLong(row[i]));
  return out;
}

PyMethodDef PageAlloc_methods[] = {
    {"can_alloc", (PyCFunction)PageAlloc_can_alloc, METH_O, nullptr},
    {"alloc_slot", (PyCFunction)PageAlloc_alloc_slot, METH_VARARGS, nullptr},
    {"extend", (PyCFunction)PageAlloc_extend, METH_VARARGS, nullptr},
    {"free_slot", (PyCFunction)PageAlloc_free_slot, METH_O, nullptr},
    {"detach_slot", (PyCFunction)PageAlloc_detach_slot, METH_O, nullptr},
    {"release_pages", (PyCFunction)PageAlloc_release_pages, METH_O, nullptr},
    {"fill_tables", (PyCFunction)PageAlloc_fill_tables, METH_VARARGS, nullptr},
    {"get_len", (PyCFunction)PageAlloc_get_len, METH_O, nullptr},
    {"num_free", (PyCFunction)PageAlloc_num_free, METH_NOARGS, nullptr},
    {"slot_pages", (PyCFunction)PageAlloc_slot_pages, METH_O, nullptr},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject PageAllocType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

PyModuleDef pagealloc_module = {
    PyModuleDef_HEAD_INIT, "tgq_torch_pagealloc",
    "Native page allocator / page-table manager for the serving engine",
    -1, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_tgq_torch_pagealloc(void) {
  PageAllocType.tp_name = "tgq_torch_pagealloc.PageAlloc";
  PageAllocType.tp_basicsize = sizeof(PageAllocObject);
  PageAllocType.tp_flags = Py_TPFLAGS_DEFAULT;
  PageAllocType.tp_new = PyType_GenericNew;
  PageAllocType.tp_init = (initproc)PageAlloc_init;
  PageAllocType.tp_dealloc = (destructor)PageAlloc_dealloc;
  PageAllocType.tp_methods = PageAlloc_methods;
  if (PyType_Ready(&PageAllocType) < 0) return nullptr;
  PyObject* m = PyModule_Create(&pagealloc_module);
  if (!m) return nullptr;
  Py_INCREF(&PageAllocType);
  PyModule_AddObject(m, "PageAlloc", (PyObject*)&PageAllocType);
  return m;
}
