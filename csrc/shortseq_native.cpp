// shortseq_tpu._native - C-speed ShortSeq object layer.
//
// A from-scratch CPython extension with the same object contract as the
// reference's Cython width classes (reference short_seq_64.pyx:33-90,
// short_seq_192.pyx:27-97, short_seq_var.pyx:15-93, dispatch
// short_seq.pyx:7-74, slicing engine short_seq.pyx:78-238): physically
// 32-byte (<=32 nt), 48-byte (<=96 nt) and 32+8/block-byte (<=1024 nt)
// objects, prehashed (hash == low packed word), lazily decoded, sliceable
// with width narrowing, XOR+popcount hamming.
//
// This is the host-side companion of the device path: bulk work belongs to
// the batched jnp/Pallas ops; these objects exist for reference-parity
// scalar access, dict keys, and Counter materialization (from_blocks).
//
// Encoding invariants shared with the device ops (shortseq_tpu/constants.py):
//   code = (ascii >> 1) & 3; nucleotide i -> block i/32, bits 2*(i%32);
//   validity = bloom constant 0xFFFFFFFFFFEFFF75 (bit set => reject);
//   decode charmap "ACTG".

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kBloom = 0xFFFFFFFFFFEFFF75ull;
constexpr uint64_t kEven = 0x5555555555555555ull;
constexpr int kNtPerBlock = 32;
constexpr int kMax64 = 32, kMax192 = 96, kMaxVar = 1024;
constexpr int kMaxReprLen = 75;
const char kCharmap[4] = {'A', 'C', 'T', 'G'};

inline Py_ssize_t blocks_for(Py_ssize_t length) {
  return (length + kNtPerBlock - 1) / kNtPerBlock;
}

// ---------------------------------------------------------------------------
// Object structs.  No cyclic references -> no GC head, so sys.getsizeof ==
// tp_basicsize (+ the var heap reported by __sizeof__), matching the
// reference's 32 / 48 / 64-288 byte footprints.

struct SS64 {
  PyObject_HEAD
  uint64_t packed;
  uint8_t length;
};

struct SS192 {
  PyObject_HEAD
  uint64_t blocks[3];
  uint8_t length;
};

struct SSVar {
  PyObject_HEAD
  uint64_t* blocks;
  uint64_t length;
};

static_assert(sizeof(SS64) == 32, "SS64 must be 32 bytes");
static_assert(sizeof(SS192) == 48, "SS192 must be 48 bytes");
static_assert(sizeof(SSVar) == 32, "SSVar header must be 32 bytes");

extern PyTypeObject SS64_Type;
extern PyTypeObject SS192_Type;
extern PyTypeObject SSVar_Type;

static PyObject* ss_empty = nullptr;  // singleton "" (reference short_seq.pyx:7)

// ---------------------------------------------------------------------------
// Bit kernels.

// SWAR helpers for the 8-bytes-at-a-time encode fast path.
inline uint64_t load_u64(const char* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

// True iff every byte of x is one of 'A' 'C' 'G' 'T' (uppercase only,
// the reference bloom's accept set).
inline bool all_acgt8(uint64_t x) {
  auto has_zero = [](uint64_t v) {
    return (v - 0x0101010101010101ull) & ~v & 0x8080808080808080ull;
  };
  auto eq = [&](uint64_t v, uint8_t c) {
    return has_zero(v ^ (0x0101010101010101ull * c));
  };
  uint64_t any = eq(x, 'A') | eq(x, 'C') | eq(x, 'G') | eq(x, 'T');
  // `any` has bit 7 set in every byte position that matched one base;
  // all 8 must match.
  return (any & 0x8080808080808080ull) == 0x8080808080808080ull;
}

// 8 ASCII bytes -> 16 packed bits (codes LSB-first).
inline uint64_t pack8(uint64_t x) {
#ifdef __BMI2__
  return __builtin_ia32_pext_di(x, 0x0606060606060606ull) ;
#else
  uint64_t v = (x >> 1) & 0x0303030303030303ull;
  v = (v | (v >> 6)) & 0x000F000F000F000Full;
  v = (v | (v >> 12)) & 0x000000FF000000FFull;
  v = (v | (v >> 24)) & 0xFFFFull;
  return v;
#endif
}

// Encode `len` ASCII bytes into pre-zeroed blocks.  Returns the offending
// byte on failure, -1 on success.  Fast path handles 8 chars per step
// (SWAR validity + pext/SWAR compaction, the host-side analog of the
// reference's _marshall_full_blocks util.pyx:100-119); the scalar tail
// also pinpoints the exact bad byte for the error message.
inline int encode_into(const char* data, Py_ssize_t len, uint64_t* blocks) {
  Py_ssize_t i = 0;
  for (; i + 8 <= len; i += 8) {
    uint64_t x = load_u64(data + i);
    if (!all_acgt8(x)) break;  // scalar loop below reports the byte
    blocks[i / kNtPerBlock] |= pack8(x) << (2 * (i % kNtPerBlock));
  }
  for (; i < len; ++i) {
    uint8_t c = (uint8_t)data[i];
    if (kBloom & (1ull << (c & 63))) return c;
    blocks[i / kNtPerBlock] |=
        (uint64_t)((c >> 1) & 3) << (2 * (i % kNtPerBlock));
  }
  return -1;
}

inline void decode_into(const uint64_t* blocks, Py_ssize_t length, char* out) {
  for (Py_ssize_t i = 0; i < length; ++i)
    out[i] = kCharmap[(blocks[i / kNtPerBlock] >> (2 * (i % kNtPerBlock))) & 3];
}

inline Py_ssize_t hamming_blocks(const uint64_t* a, const uint64_t* b,
                                 Py_ssize_t length) {
  Py_ssize_t total = 0;
  Py_ssize_t nb = blocks_for(length);
  for (Py_ssize_t i = 0; i < nb; ++i) {
    uint64_t c = a[i] ^ b[i];
    c = ((c >> 1) | c) & kEven;
    total += __builtin_popcountll(c);
  }
  return total;
}

// Extract `length` nts starting at `start` into pre-zeroed dst blocks
// (semantics of reference _slice/_shift_copy_trim short_seq.pyx:94-238,
// with explicit bounds instead of its one-past-the-end read).
inline void slice_into(const uint64_t* src, Py_ssize_t src_blocks,
                       Py_ssize_t start, Py_ssize_t length, uint64_t* dst) {
  Py_ssize_t block0 = start / kNtPerBlock;
  int offset = 2 * (start % kNtPerBlock);
  Py_ssize_t n_out = blocks_for(length);
  for (Py_ssize_t i = 0; i < n_out; ++i) {
    uint64_t lo = block0 + i < src_blocks ? src[block0 + i] >> offset : 0;
    uint64_t hi = 0;
    if (offset && block0 + i + 1 < src_blocks)
      hi = src[block0 + i + 1] << (64 - offset);
    dst[i] = lo | hi;
  }
  int tail = (int)((2 * length) % 64);
  if (tail) dst[n_out - 1] &= (1ull << tail) - 1;
}

// ---------------------------------------------------------------------------
// Accessors generic over the three widths.

inline const uint64_t* get_blocks(PyObject* o, uint64_t* scratch) {
  if (Py_TYPE(o) == &SS64_Type) {
    *scratch = ((SS64*)o)->packed;
    return scratch;
  }
  if (Py_TYPE(o) == &SS192_Type) return ((SS192*)o)->blocks;
  return ((SSVar*)o)->blocks;
}

inline Py_ssize_t get_length(PyObject* o) {
  if (Py_TYPE(o) == &SS64_Type) return ((SS64*)o)->length;
  if (Py_TYPE(o) == &SS192_Type) return ((SS192*)o)->length;
  return (Py_ssize_t)((SSVar*)o)->length;
}

inline bool is_shortseq(PyObject* o) {
  return Py_TYPE(o) == &SS64_Type || Py_TYPE(o) == &SS192_Type ||
         Py_TYPE(o) == &SSVar_Type;
}

// Build the narrowest object owning `blocks` content for `length` nts
// (reference _slice narrowing short_seq.pyx:94-116).
static PyObject* make_from_blocks(const uint64_t* blocks, Py_ssize_t length) {
  if (length == 0) {
    Py_INCREF(ss_empty);
    return ss_empty;
  }
  if (length <= kMax64) {
    SS64* o = PyObject_New(SS64, &SS64_Type);
    if (!o) return nullptr;
    o->packed = blocks[0];
    o->length = (uint8_t)length;
    return (PyObject*)o;
  }
  if (length <= kMax192) {
    SS192* o = PyObject_New(SS192, &SS192_Type);
    if (!o) return nullptr;
    Py_ssize_t nb = blocks_for(length);
    for (int i = 0; i < 3; ++i) o->blocks[i] = i < nb ? blocks[i] : 0;
    o->length = (uint8_t)length;
    return (PyObject*)o;
  }
  Py_ssize_t nb = blocks_for(length);
  SSVar* o = PyObject_New(SSVar, &SSVar_Type);
  if (!o) return nullptr;
  o->blocks = (uint64_t*)PyMem_Calloc(nb, sizeof(uint64_t));
  if (!o->blocks) {
    Py_DECREF(o);
    return PyErr_NoMemory();
  }
  memcpy(o->blocks, blocks, nb * sizeof(uint64_t));
  o->length = (uint64_t)length;
  return (PyObject*)o;
}

// Encode raw chars -> narrowest object (reference _new short_seq.pyx:54-74).
static PyObject* new_from_chars(const char* data, Py_ssize_t len) {
  if (len == 0) {
    Py_INCREF(ss_empty);
    return ss_empty;
  }
  if (len > kMaxVar) {
    PyErr_SetString(PyExc_Exception,
                    "Sequences longer than 1024 bases are not supported.");
    return nullptr;
  }
  uint64_t blocks[kMaxVar / kNtPerBlock] = {0};
  int bad = encode_into(data, len, blocks);
  if (bad >= 0) {
    PyErr_Format(PyExc_Exception, "Unsupported base character: %c", bad);
    return nullptr;
  }
  return make_from_blocks(blocks, len);
}

// ---------------------------------------------------------------------------
// Shared dunder implementations.

static Py_hash_t ss_hash(PyObject* self) {
  uint64_t scratch;
  Py_hash_t h = (Py_hash_t)get_blocks(self, &scratch)[0];
  return h == -1 ? -2 : h;  // CPython reserves -1 for errors
}

static PyObject* ss_str(PyObject* self) {
  char buf[kMaxVar];
  uint64_t scratch;
  Py_ssize_t length = get_length(self);
  decode_into(get_blocks(self, &scratch), length, buf);
  return PyUnicode_DecodeASCII(buf, length, nullptr);
}

static PyObject* ss_richcompare(PyObject* self, PyObject* other, int op) {
  if (op != Py_EQ && op != Py_NE) Py_RETURN_NOTIMPLEMENTED;
  bool eq = false;
  if (Py_TYPE(other) == Py_TYPE(self)) {
    Py_ssize_t la = get_length(self), lb = get_length(other);
    if (la == lb) {
      uint64_t sa, sb;
      const uint64_t* ba = get_blocks(self, &sa);
      const uint64_t* bb = get_blocks(other, &sb);
      eq = memcmp(ba, bb, blocks_for(la) * sizeof(uint64_t)) == 0;
    }
  } else if (PyUnicode_Check(other)) {
    Py_ssize_t la = get_length(self);
    if (PyUnicode_IS_ASCII(other) &&
        PyUnicode_GET_LENGTH(other) == la) {
      char buf[kMaxVar];
      uint64_t scratch;
      decode_into(get_blocks(self, &scratch), la, buf);
      eq = memcmp(buf, PyUnicode_1BYTE_DATA(other), la) == 0;
    }
  } else if (PyBytes_Check(other)) {
    // Parity quirk: the reference compares str(self) == other even for
    // bytes (short_seq_64.pyx:45-47), and str == bytes is always False in
    // Python 3 - so equality against bytes is False, matching both the
    // reference and the pure-Python backend.
    eq = false;
  } else if (is_shortseq(other)) {
    eq = false;  // different width classes never compare equal
  } else {
    eq = false;  // match the python backend: == on foreign types is False
  }
  if (op == Py_NE) eq = !eq;
  return PyBool_FromLong(eq);
}

static Py_ssize_t ss_len(PyObject* self) { return get_length(self); }

// Bounds-checked 1-nt ShortSeq64 at `index` (reference _subscript
// short_seq.pyx:78-91); shared by the mapping and sequence slots.
static PyObject* make_base(const uint64_t* blocks, Py_ssize_t length,
                           Py_ssize_t index) {
  if (index < 0 || index >= length) {
    PyErr_SetString(PyExc_IndexError, "Sequence index out of range");
    return nullptr;
  }
  SS64* o = PyObject_New(SS64, &SS64_Type);
  if (!o) return nullptr;
  o->packed = (blocks[index / kNtPerBlock] >> (2 * (index % kNtPerBlock))) & 3;
  o->length = 1;
  return (PyObject*)o;
}

static PyObject* ss_subscript(PyObject* self, PyObject* item) {
  uint64_t scratch;
  const uint64_t* blocks = get_blocks(self, &scratch);
  Py_ssize_t length = get_length(self);
  if (PySlice_Check(item)) {
    Py_ssize_t start, stop, step;
    if (PySlice_Unpack(item, &start, &stop, &step) < 0) return nullptr;
    if (step != 1) {
      PyErr_SetString(PyExc_TypeError, "Slice step not supported");
      return nullptr;
    }
    Py_ssize_t slice_len = PySlice_AdjustIndices(length, &start, &stop, 1);
    if (slice_len <= 0) {
      Py_INCREF(ss_empty);
      return ss_empty;
    }
    uint64_t out[kMaxVar / kNtPerBlock] = {0};
    slice_into(blocks, blocks_for(length), start, slice_len, out);
    return make_from_blocks(out, slice_len);
  }
  if (PyLong_Check(item)) {
    // Exact int only (plus bool/int subclasses), matching the python
    // backend's isinstance(item, int) and the reference (short_seq_64.pyx
    // :67) - numpy integers raise the Invalid-index TypeError on every
    // backend rather than working only when the extension compiled.
    Py_ssize_t index = PyLong_AsSsize_t(item);
    if (index == -1 && PyErr_Occurred()) return nullptr;
    if (index < 0) index += length;
    return make_base(blocks, length, index);
  }
  PyErr_Format(PyExc_TypeError, "Invalid index type: %R", (PyObject*)Py_TYPE(item));
  return nullptr;
}

static PyObject* ss_seq_item(PyObject* self, Py_ssize_t index) {
  // sq_item slot: powers the legacy iteration protocol (iter(seq),
  // zip(a, b) - used by the reference's own README/test code), falling
  // back to per-base ShortSeq64s until IndexError.  Indexing expressions
  // go through mp_subscript instead (mapping slot wins).
  uint64_t scratch;
  const uint64_t* blocks = get_blocks(self, &scratch);
  return make_base(blocks, get_length(self), index);
}

static PyObject* ss_xor(PyObject* self, PyObject* other) {
  if (!is_shortseq(self) || Py_TYPE(other) != Py_TYPE(self)) {
    PyErr_Format(PyExc_TypeError,
                 "Argument 'other' has incorrect type (expected %s, got %s)",
                 is_shortseq(self) ? Py_TYPE(self)->tp_name
                                   : Py_TYPE(other)->tp_name,
                 is_shortseq(self) ? Py_TYPE(other)->tp_name
                                   : Py_TYPE(self)->tp_name);
    return nullptr;
  }
  Py_ssize_t la = get_length(self), lb = get_length(other);
  if (la != lb) {
    PyErr_Format(PyExc_Exception,
                 "Hamming distance requires sequences of equal length "
                 "(%zd != %zd)", la, lb);
    return nullptr;
  }
  uint64_t sa, sb;
  return PyLong_FromSsize_t(
      hamming_blocks(get_blocks(self, &sa), get_blocks(other, &sb), la));
}

static PyObject* ss_repr(PyObject* self) {
  char buf[kMaxVar + 1];
  uint64_t scratch;
  Py_ssize_t length = get_length(self);
  const uint64_t* blocks = get_blocks(self, &scratch);
  if (Py_TYPE(self) == &SSVar_Type) {
    // Truncated repr (reference short_seq_var.pyx:86-89)
    decode_into(blocks, kMaxReprLen, buf);
    buf[kMaxReprLen] = '\0';
    return PyUnicode_FromFormat("<%s (%zd nt): %s ... >",
                                Py_TYPE(self)->tp_name, length, buf);
  }
  decode_into(blocks, length, buf);
  buf[length] = '\0';
  return PyUnicode_FromFormat("<%s (%zd nt): %s>", Py_TYPE(self)->tp_name,
                              length, buf);
}

static PyObject* ss64_sizeof(PyObject* self, PyObject*) {
  return PyLong_FromSsize_t(sizeof(SS64));
}

static PyObject* ss192_sizeof(PyObject* self, PyObject*) {
  return PyLong_FromSsize_t(sizeof(SS192));
}

static PyObject* ssvar_sizeof(PyObject* self, PyObject*) {
  // 32 B header + 8 B per block (reference short_seq_var.pxd:14-17)
  return PyLong_FromSsize_t(
      sizeof(SSVar) + blocks_for(get_length(self)) * sizeof(uint64_t));
}

static void ssvar_dealloc(PyObject* self) {
  PyMem_Free(((SSVar*)self)->blocks);
  Py_TYPE(self)->tp_free(self);
}

static PyObject* ss_new_disabled(PyTypeObject* type, PyObject*, PyObject*) {
  PyErr_Format(PyExc_TypeError,
               "%s objects are created with pack()/from_str()/from_bytes()",
               type->tp_name);
  return nullptr;
}

static PyMethodDef ss64_methods[] = {
    {"__sizeof__", ss64_sizeof, METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr}};
static PyMethodDef ss192_methods[] = {
    {"__sizeof__", ss192_sizeof, METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr}};
static PyMethodDef ssvar_methods[] = {
    {"__sizeof__", ssvar_sizeof, METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr}};

static PyNumberMethods ss_as_number = []() {
  PyNumberMethods m = {};
  m.nb_xor = ss_xor;
  return m;
}();

static PyMappingMethods ss_as_mapping = {ss_len, ss_subscript, nullptr};

static PySequenceMethods ss_as_sequence = []() {
  PySequenceMethods m = {};
  m.sq_length = ss_len;
  m.sq_item = ss_seq_item;
  return m;
}();

static PyTypeObject make_type(const char* name, Py_ssize_t basicsize,
                              PyMethodDef* methods, destructor dealloc) {
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = name;
  t.tp_basicsize = basicsize;
  t.tp_dealloc = dealloc;
  t.tp_repr = ss_repr;
  t.tp_as_number = &ss_as_number;
  t.tp_as_sequence = &ss_as_sequence;
  t.tp_as_mapping = &ss_as_mapping;
  t.tp_hash = ss_hash;
  t.tp_str = ss_str;
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_richcompare = ss_richcompare;
  t.tp_methods = methods;
  t.tp_new = ss_new_disabled;
  return t;
}

PyTypeObject SS64_Type =
    make_type("ShortSeq64", sizeof(SS64), ss64_methods, nullptr);
PyTypeObject SS192_Type =
    make_type("ShortSeq192", sizeof(SS192), ss192_methods, nullptr);
PyTypeObject SSVar_Type =
    make_type("ShortSeqVar", sizeof(SSVar), ssvar_methods, ssvar_dealloc);

// ---------------------------------------------------------------------------
// Module functions (reference short_seq.pyx:14-48 dispatch).

static PyObject* from_str_impl(PyObject* s) {
  if (!PyUnicode_IS_ASCII(s)) {
    // Find the first non-ASCII char for the reference-style message.
    Py_ssize_t n = PyUnicode_GET_LENGTH(s);
    for (Py_ssize_t i = 0; i < n; ++i) {
      Py_UCS4 c = PyUnicode_READ_CHAR(s, i);
      if (c > 127)
        return PyErr_Format(PyExc_Exception,
                            "Unsupported base character: %c", (int)c);
    }
  }
  return new_from_chars((const char*)PyUnicode_1BYTE_DATA(s),
                        PyUnicode_GET_LENGTH(s));
}

static PyObject* py_pack(PyObject*, PyObject* seq) {
  if (PyUnicode_Check(seq)) return from_str_impl(seq);
  if (PyBytes_Check(seq))
    return new_from_chars(PyBytes_AS_STRING(seq), PyBytes_GET_SIZE(seq));
  if (is_shortseq(seq)) {
    Py_INCREF(seq);
    return seq;
  }
  return PyErr_Format(PyExc_TypeError, "Cannot pack objects of type \"%R\"",
                      (PyObject*)Py_TYPE(seq));
}

static PyObject* py_from_str(PyObject*, PyObject* s) {
  if (!PyUnicode_Check(s))
    return PyErr_Format(PyExc_TypeError, "expected str, got %R",
                        (PyObject*)Py_TYPE(s));
  return from_str_impl(s);
}

static PyObject* py_from_bytes(PyObject*, PyObject* b) {
  if (!PyBytes_Check(b))
    return PyErr_Format(PyExc_TypeError, "expected bytes, got %R",
                        (PyObject*)Py_TYPE(b));
  return new_from_chars(PyBytes_AS_STRING(b), PyBytes_GET_SIZE(b));
}

static PyObject* py_from_blocks(PyObject*, PyObject* args) {
  PyObject* blocks_obj;
  Py_ssize_t length;
  if (!PyArg_ParseTuple(args, "On", &blocks_obj, &length)) return nullptr;
  if (length < 0 || length > kMaxVar) {
    PyErr_SetString(PyExc_Exception,
                    "Sequences longer than 1024 bases are not supported.");
    return nullptr;
  }
  PyObject* fast = PySequence_Fast(blocks_obj, "blocks must be a sequence");
  if (!fast) return nullptr;
  Py_ssize_t nb = PySequence_Fast_GET_SIZE(fast);
  uint64_t blocks[kMaxVar / kNtPerBlock] = {0};
  Py_ssize_t need = blocks_for(length);
  if (nb < need && length > 0) {
    // Zero-filling missing blocks would fabricate 'A' bases; stay loud
    // and backend-identical (api/seq.from_blocks raises the same).
    PyErr_Format(PyExc_ValueError,
                 "from_blocks: %zd blocks given, %zd needed for length %zd",
                 nb, need, length);
    Py_DECREF(fast);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < nb && i < need; ++i) {
    blocks[i] = PyLong_AsUnsignedLongLongMask(
        PySequence_Fast_GET_ITEM(fast, i));
    if (PyErr_Occurred()) {
      Py_DECREF(fast);
      return nullptr;
    }
  }
  Py_DECREF(fast);
  // Mask bits above 2*length in the last block: stray garbage there
  // would make hash/eq disagree with pack() of the same decoded string
  // (hash IS the packed word), silently splitting Counter keys.
  Py_ssize_t rem = length % kNtPerBlock;
  if (length > 0 && rem)
    blocks[need - 1] &= (~0ull) >> (64 - 2 * rem);
  return make_from_blocks(blocks, length);
}

// Count a list of PyBytes reads into a dict (the C-speed ingest the
// reference gets from its private known-hash dict calls,
// counter.pyx:22-54; here the public PyDict C API + the types' C-level
// hash/eq give the same speed class).  Writes bypass any __setitem__
// override, as the reference's do.
static PyObject* py_count_bytes_list(PyObject*, PyObject* args) {
  PyObject* dict;
  PyObject* list;
  if (!PyArg_ParseTuple(args, "O!O!", &PyDict_Type, &dict, &PyList_Type,
                        &list))
    return nullptr;
  PyObject* one = PyLong_FromLong(1);
  if (!one) return nullptr;
  // Re-read the size every iteration: dict operations below can run
  // arbitrary Python (__eq__ of a hash-colliding foreign key, GC) that
  // may mutate the list.
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(list); ++i) {
    PyObject* item = PyList_GET_ITEM(list, i);
    if (!PyBytes_Check(item)) {
      Py_DECREF(one);
      return PyErr_Format(PyExc_TypeError,
                          "expected bytes at index %zd, got %R", i,
                          (PyObject*)Py_TYPE(item));
    }
    PyObject* key =
        new_from_chars(PyBytes_AS_STRING(item), PyBytes_GET_SIZE(item));
    if (!key) {
      Py_DECREF(one);
      return nullptr;
    }
    PyObject* cur = PyDict_GetItemWithError(dict, key);  // borrowed
    int rc;
    if (cur) {
      // PyNumber_Add (like the reference's `oldval + 1`, counter.pyx:53)
      // raises a clean TypeError on non-numeric values and never wraps.
      PyObject* nv = PyNumber_Add(cur, one);
      rc = nv ? PyDict_SetItem(dict, key, nv) : -1;
      Py_XDECREF(nv);
    } else if (PyErr_Occurred()) {
      rc = -1;
    } else {
      rc = PyDict_SetItem(dict, key, one);
    }
    Py_DECREF(key);
    if (rc < 0) {
      Py_DECREF(one);
      return nullptr;
    }
  }
  Py_DECREF(one);
  Py_RETURN_NONE;
}

// --- Batch materialization from device count tables ------------------------
//
// The device count engine (shortseq_tpu/count/device.py) produces
// struct-of-arrays tables: words [M, W] uint32 lanes, lengths [M] int32,
// counts [M] int32/int64.  Materializing a ShortSeqCounter from them used
// to be a per-key Python loop (tuple build + from_blocks call + dict
// insert per row); these entry points do the whole table in one C call -
// the role _PyDict_SetItem_KnownHash plays in the reference's ingest
// (reference counter.pyx:41-54).

struct TableView {
  Py_buffer words, lengths, counts;
  Py_ssize_t n, lanes;
  bool ok;
};

static void table_release(TableView* t) {
  if (t->words.obj) PyBuffer_Release(&t->words);
  if (t->lengths.obj) PyBuffer_Release(&t->lengths);
  if (t->counts.obj) PyBuffer_Release(&t->counts);
}

// Acquire C-contiguous buffers for (words [M, W] u32, lengths [M] i32,
// counts [M] i32/i64 or nullptr).  Validates shapes agree.
static TableView table_acquire(PyObject* words, PyObject* lengths,
                               PyObject* counts) {
  TableView t = {};
  t.ok = false;
  if (PyObject_GetBuffer(words, &t.words, PyBUF_C_CONTIGUOUS) < 0) return t;
  if (PyObject_GetBuffer(lengths, &t.lengths, PyBUF_C_CONTIGUOUS) < 0) {
    table_release(&t);
    return t;
  }
  if (counts &&
      PyObject_GetBuffer(counts, &t.counts, PyBUF_C_CONTIGUOUS) < 0) {
    table_release(&t);
    return t;
  }
  if (t.words.ndim != 2 || t.words.itemsize != 4 || t.lengths.ndim != 1 ||
      t.lengths.itemsize != 4 ||
      (counts && (t.counts.ndim != 1 ||
                  (t.counts.itemsize != 4 && t.counts.itemsize != 8)))) {
    PyErr_SetString(PyExc_TypeError,
                    "expected words uint32 [M, W], lengths int32 [M], "
                    "counts int32/int64 [M]");
    table_release(&t);
    return t;
  }
  t.n = t.words.shape[0];
  t.lanes = t.words.shape[1];
  if (t.lengths.shape[0] != t.n || (counts && t.counts.shape[0] != t.n)) {
    PyErr_SetString(PyExc_ValueError, "table arrays disagree on row count");
    table_release(&t);
    return t;
  }
  t.ok = true;
  return t;
}

// Lane row (uint32 LE pairs) -> narrowest ShortSeq object.
static PyObject* row_to_seq(const uint32_t* lanes, Py_ssize_t n_lanes,
                            Py_ssize_t length) {
  if (length < 0 || length > kMaxVar) {
    PyErr_Format(PyExc_ValueError, "invalid row length %zd", length);
    return nullptr;
  }
  if (length > n_lanes * 16) {  // truncated/width-mismatched table: the
    // zero-filled missing lanes would decode as fabricated 'A' bases
    PyErr_Format(PyExc_ValueError,
                 "row length %zd exceeds table capacity (%zd lanes = %zd nt)",
                 length, n_lanes, n_lanes * 16);
    return nullptr;
  }
  uint64_t blocks[kMaxVar / kNtPerBlock] = {0};
  Py_ssize_t nb = blocks_for(length);
  for (Py_ssize_t b = 0; b < nb; ++b) {
    uint64_t lo = 2 * b < n_lanes ? lanes[2 * b] : 0;
    uint64_t hi = 2 * b + 1 < n_lanes ? lanes[2 * b + 1] : 0;
    blocks[b] = lo | (hi << 32);
  }
  return make_from_blocks(blocks, length);
}

// update_from_table(dict, words, lengths, counts): add each row's count to
// dict[row_key].  One call per table instead of one Python iteration per
// unique read.
static PyObject* py_update_from_table(PyObject*, PyObject* args) {
  PyObject* dict;
  PyObject* words;
  PyObject* lengths;
  PyObject* counts;
  if (!PyArg_ParseTuple(args, "O!OOO", &PyDict_Type, &dict, &words, &lengths,
                        &counts))
    return nullptr;
  TableView t = table_acquire(words, lengths, counts);
  if (!t.ok) return nullptr;
  const uint32_t* w = (const uint32_t*)t.words.buf;
  const int32_t* lens = (const int32_t*)t.lengths.buf;
  int ok = 1;
  for (Py_ssize_t i = 0; i < t.n && ok; ++i) {
    long long c = t.counts.itemsize == 8
                      ? ((const int64_t*)t.counts.buf)[i]
                      : (long long)((const int32_t*)t.counts.buf)[i];
    PyObject* key = row_to_seq(w + i * t.lanes, t.lanes, lens[i]);
    if (!key) {
      ok = 0;
      break;
    }
    // Table rows are unique within a call, so the key is almost never
    // present: SetDefault inserts with ONE hash+lookup (vs the
    // Get-then-Set double walk) and only a genuine collision (counter
    // pre-populated, or a cross-call merge) pays the add+replace.
    // "Key existed" is detected by the dict SIZE, never by comparing
    // the returned pointer to nv: CPython interns small ints, so an
    // existing count equal to the incoming one IS the same object.
    PyObject* nv = PyLong_FromLongLong(c);
    if (!nv) {
      ok = 0;
    } else {
      Py_ssize_t before = PyDict_GET_SIZE(dict);
      PyObject* got = PyDict_SetDefault(dict, key, nv);  // borrowed
      if (!got) {
        ok = 0;
      } else if (PyDict_GET_SIZE(dict) == before) {  // existed: add
        PyObject* sum = PyNumber_Add(got, nv);
        ok = sum && PyDict_SetItem(dict, key, sum) == 0;
        Py_XDECREF(sum);
      }
      Py_DECREF(nv);
    }
    Py_DECREF(key);
  }
  table_release(&t);
  if (!ok) return nullptr;
  Py_RETURN_NONE;
}

// seqs_from_rows(words, lengths) -> list[ShortSeq]: batch object
// materialization straight from packed lanes (no re-encoding).
static PyObject* py_seqs_from_rows(PyObject*, PyObject* args) {
  PyObject* words;
  PyObject* lengths;
  if (!PyArg_ParseTuple(args, "OO", &words, &lengths)) return nullptr;
  TableView t = table_acquire(words, lengths, nullptr);
  if (!t.ok) return nullptr;
  const uint32_t* w = (const uint32_t*)t.words.buf;
  const int32_t* lens = (const int32_t*)t.lengths.buf;
  PyObject* out = PyList_New(t.n);
  if (out) {
    for (Py_ssize_t i = 0; i < t.n; ++i) {
      PyObject* o = row_to_seq(w + i * t.lanes, t.lanes, lens[i]);
      if (!o) {
        Py_CLEAR(out);
        break;
      }
      PyList_SET_ITEM(out, i, o);
    }
  }
  table_release(&t);
  return out;
}

static PyObject* py_domain(PyObject*, PyObject* args, int lo, int hi) {
  return Py_BuildValue("(ii)", lo, hi);
}

static PyObject* py_domain_64(PyObject* m, PyObject* a) {
  return py_domain(m, a, 0, kMax64);
}
static PyObject* py_domain_192(PyObject* m, PyObject* a) {
  return py_domain(m, a, kMax64 + 1, kMax192);
}
static PyObject* py_domain_var(PyObject* m, PyObject* a) {
  return py_domain(m, a, kMax192 + 1, kMaxVar);
}

static PyMethodDef module_methods[] = {
    {"pack", py_pack, METH_O,
     "Type-dispatched constructor (str/bytes/ShortSeq passthrough)."},
    {"from_str", py_from_str, METH_O, nullptr},
    {"from_bytes", py_from_bytes, METH_O, nullptr},
    {"from_blocks", py_from_blocks, METH_VARARGS,
     "Build a ShortSeq from reference uint64 blocks + length."},
    {"count_bytes_list", py_count_bytes_list, METH_VARARGS,
     "Count a list of bytes reads into a dict of ShortSeq keys."},
    {"update_from_table", py_update_from_table, METH_VARARGS,
     "Add a (words, lengths, counts) device count table into a dict."},
    {"seqs_from_rows", py_seqs_from_rows, METH_VARARGS,
     "Materialize a list of ShortSeq objects from packed lane rows."},
    {"get_domain_64", py_domain_64, METH_NOARGS, nullptr},
    {"get_domain_192", py_domain_192, METH_NOARGS, nullptr},
    {"get_domain_var", py_domain_var, METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr}};

static PyModuleDef native_module = {
    PyModuleDef_HEAD_INIT, "_native",
    "C-speed ShortSeq object layer for shortseq_tpu.", -1, module_methods};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) {
  if (PyType_Ready(&SS64_Type) < 0 || PyType_Ready(&SS192_Type) < 0 ||
      PyType_Ready(&SSVar_Type) < 0)
    return nullptr;
  PyObject* m = PyModule_Create(&native_module);
  if (!m) return nullptr;

  SS64* e = PyObject_New(SS64, &SS64_Type);
  if (!e) return nullptr;
  e->packed = 0;
  e->length = 0;
  ss_empty = (PyObject*)e;

  Py_INCREF(&SS64_Type);
  PyModule_AddObject(m, "ShortSeq64", (PyObject*)&SS64_Type);
  Py_INCREF(&SS192_Type);
  PyModule_AddObject(m, "ShortSeq192", (PyObject*)&SS192_Type);
  Py_INCREF(&SSVar_Type);
  PyModule_AddObject(m, "ShortSeqVar", (PyObject*)&SSVar_Type);
  Py_INCREF(ss_empty);
  PyModule_AddObject(m, "empty", ss_empty);
  return m;
}
