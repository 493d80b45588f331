/* Native hot loops for the replay path (CPython extension).
 *
 * The reference scheduler's runtime is compiled Go end to end; here the
 * solve is a CUDA kernel, and this module compiles the one remaining
 * interpreter-bound stretch: the bulk session-mutation loop that replays
 * kernel assignments into Python session objects
 * (actions/torch_allocate._Replayer.apply_upto — the net state mutations
 * of ssn.allocate/pipeline, session.go:198-296, at 50k-100k events per
 * cycle), and the encoder's per-task extraction passes.
 *
 * Approach: TaskInfo (api/job_info.py) is a __slots__ class, so its
 * attributes live at fixed byte offsets published by the class's
 * member descriptors (PyMemberDescrObject.d_member->offset). We cache
 * the offsets per type and do the per-event work — status flip,
 * node_name set, residency clone (clone_for_residency parity: shares
 * Resource objects, copies every slot), node task-map insert, status-
 * index dict build — as direct pointer stores + PyDict_SetItem calls,
 * with no interpreter frames. Everything is plain public CPython API
 * (descrobject.h, PyType_GenericAlloc via tp_alloc); a type without
 * the expected slots raises and the caller falls back to the pure-
 * Python loop.
 *
 * Build: native/build.py (g++ -O2 -std=c++17 -fPIC -shared) into the
 * package's _build directory; loaded by native/__init__.py. The package
 * switch native.set_enabled(False) runs every caller's Python twin.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <algorithm>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

/* ---- slot offset cache --------------------------------------------------- */

constexpr int kNumSlots = 11;
/* Order matches TaskInfo.__slots__ (api/job_info.py); the clone copies
 * all of them, the surgery writes a subset. */
const char* const kSlotNames[kNumSlots] = {
    "uid",     "job",    "name",     "namespace", "resreq", "init_resreq",
    "node_name", "status", "priority", "volume_ready", "pod",
};
constexpr int kUid = 0;
constexpr int kName = 2;
constexpr int kNamespace = 3;
constexpr int kNodeName = 6;
constexpr int kStatus = 7;
constexpr int kPriority = 8;
constexpr int kVolumeReady = 9;
constexpr int kPod = 10;

struct SlotCache {
  PyTypeObject* type = nullptr;  // borrowed; identity-checked per call
  Py_ssize_t off[kNumSlots];
};

SlotCache g_task_slots;

/* Resolve the byte offset of each __slots__ member descriptor on `tp`.
 * Returns 0 on success, -1 (with a Python error set) when any name is
 * not a plain member slot — the caller then uses the Python path.
 * Resolves into a local table and commits atomically so a mid-loop
 * failure cannot leave a half-overwritten cache behind a stale type
 * identity. */
int resolve_slots(PyTypeObject* tp, SlotCache* cache) {
  SlotCache local;
  for (int i = 0; i < kNumSlots; i++) {
    PyObject* descr = PyObject_GetAttrString((PyObject*)tp, kSlotNames[i]);
    if (descr == nullptr) return -1;
    if (Py_TYPE(descr) != &PyMemberDescr_Type) {
      Py_DECREF(descr);
      PyErr_Format(PyExc_TypeError, "%s.%s is not a slot member",
                   tp->tp_name, kSlotNames[i]);
      return -1;
    }
    local.off[i] = ((PyMemberDescrObject*)descr)->d_member->offset;
    Py_DECREF(descr);
  }
  local.type = tp;
  *cache = local;
  return 0;
}

inline PyObject* get_slot(PyObject* o, Py_ssize_t off) {
  return *(PyObject**)((char*)o + off);  // borrowed
}

inline void set_slot(PyObject* o, Py_ssize_t off, PyObject* v) {
  PyObject** p = (PyObject**)((char*)o + off);
  Py_INCREF(v);
  PyObject* old = *p;
  *p = v;
  Py_XDECREF(old);
}

/* clone_for_residency parity: new instance of the same type, every slot
 * shared by reference (Resource objects included — they are never
 * mutated on a TaskInfo after construction; see job_info.py docstring).
 *
 * The clone is removed from cycle-GC tracking: nothing a TaskInfo
 * references (strings, Resource, Pod, TaskStatus) can reach the clone
 * back — the clone lives only in NodeInfo.tasks, never in the job
 * indexes — so it cannot participate in a cycle and plain refcounting
 * frees it. Untracking keeps 50k-100k fresh clones out of every gen-0
 * collection during the replay. */
PyObject* clone_slots(PyObject* task, const SlotCache& sc) {
  PyTypeObject* tp = Py_TYPE(task);
  PyObject* cl = tp->tp_alloc(tp, 0);
  if (cl == nullptr) return nullptr;
  for (int i = 0; i < kNumSlots; i++) {
    PyObject* v = get_slot(task, sc.off[i]);
    Py_XINCREF(v);
    *(PyObject**)((char*)cl + sc.off[i]) = v;
  }
  if (PyObject_GC_IsTracked(cl)) PyObject_GC_UnTrack(cl);
  return cl;
}

/* ---- bulk_assign --------------------------------------------------------- */

PyObject* g_volumes_name = nullptr;  // interned "volumes"

/* bulk_assign(tasks, tkeys, node_tasks, node_names, rows, nrows,
 *             allocs, counts, ALLOCATED, PIPELINED)
 *
 *   tasks      list[TaskInfo]  row-indexed (encoder order)
 *   tkeys      list[str]       row-indexed "ns/name" node-map keys
 *   node_tasks list[dict]      per node row: NodeInfo.tasks
 *   node_names list[str]       per node row: node name
 *   rows       list[int]       event rows, kernel order grouped per job
 *   nrows      list[int]       event node rows (parallel to rows)
 *   allocs     bytes           1 = Allocated, 0 = Pipelined (parallel)
 *   counts     list[int]       events per job segment (sum = len(rows))
 *   ALLOCATED / PIPELINED      TaskStatus members
 *
 * Per event, exactly the Python loop's mutations in its order:
 *   volume_ready=True (Allocated, volume-less), status flip, uid->task
 *   into the segment's alloc/pipe dict, node_name set, residency clone
 *   into node_tasks[nrow][tkeys[row]].
 * Returns list[(alloc_d, pipe_d)] per segment.
 *
 * A task with pod.volumes on an Allocated event needs the volume
 * binder (host-side assume) — detected in a mutation-free prepass and
 * raised as ValueError so the caller falls back cleanly. */
/* rows/nrows arrive as Python int lists OR int64 buffers (numpy
 * arrays) — the buffer form spares the caller 2n PyLong boxings and
 * this function 2n unboxings on the 200k-event replay path. */
static int read_index_vec(PyObject* obj, Py_ssize_t* out, Py_ssize_t n,
                          Py_ssize_t limit, const char* what) {
  if (PyList_Check(obj)) {
    if (PyList_GET_SIZE(obj) != n) {
      PyErr_Format(PyExc_ValueError, "%s length mismatch", what);
      return -1;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
      Py_ssize_t v = PyLong_AsSsize_t(PyList_GET_ITEM(obj, i));
      if (v == -1 && PyErr_Occurred()) return -1;
      if (v < 0 || v >= limit) {
        PyErr_SetString(PyExc_IndexError, "row index out of range");
        return -1;
      }
      out[i] = v;
    }
    return 0;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(obj, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
    return -1;
  int rc = -1;
  if (view.ndim != 1 || view.shape[0] != n || view.itemsize != 8 ||
      view.format == nullptr ||
      !(view.format[0] == 'l' || view.format[0] == 'q')) {
    PyErr_Format(PyExc_TypeError, "%s must be an int64 vector of length %zd",
                 what, n);
  } else {
    const int64_t* src = (const int64_t*)view.buf;
    rc = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
      if (src[i] < 0 || src[i] >= limit) {
        PyErr_SetString(PyExc_IndexError, "row index out of range");
        rc = -1;
        break;
      }
      out[i] = (Py_ssize_t)src[i];
    }
  }
  PyBuffer_Release(&view);
  return rc;
}

PyObject* bulk_assign(PyObject*, PyObject* args) {
  PyObject *tasks, *tkeys, *node_tasks, *node_names, *rows, *nrows;
  PyObject *allocs, *counts, *st_alloc, *st_pipe;
  /* trusted=1: the caller vouches that no bulk row carries volume
   * claims (ops/encode.py routes volume pods host_only, so rows from
   * that encoder satisfy it by construction) — the per-event
   * pod.volumes GetAttr, measured at ~half this function's cost on a
   * 400k replay, is skipped. Custom encoders must pass 0 (default). */
  int trusted = 0;
  if (!PyArg_ParseTuple(args, "O!O!O!O!OOSO!OO|p", &PyList_Type, &tasks,
                        &PyList_Type, &tkeys, &PyList_Type, &node_tasks,
                        &PyList_Type, &node_names, &rows,
                        &nrows, &allocs, &PyList_Type, &counts,
                        &st_alloc, &st_pipe, &trusted))
    return nullptr;

  Py_ssize_t n = PyBytes_GET_SIZE(allocs);
  const char* is_alloc = PyBytes_AS_STRING(allocs);
  Py_ssize_t n_tasks = PyList_GET_SIZE(tasks);
  Py_ssize_t n_nodes = PyList_GET_SIZE(node_tasks);
  if (PyList_GET_SIZE(tkeys) != n_tasks ||
      PyList_GET_SIZE(node_names) != n_nodes) {
    PyErr_SetString(PyExc_ValueError, "tkeys/node_names length mismatch");
    return nullptr;
  }

  /* Decode row/nrow indices once, bounds-checked. */
  Py_ssize_t n_seg = PyList_GET_SIZE(counts);
  Py_ssize_t* seg_cnt = nullptr;  // freed at fail_ix (PyMem_Free(NULL) ok)
  Py_ssize_t* row_ix = (Py_ssize_t*)PyMem_Malloc(2 * n * sizeof(Py_ssize_t));
  if (row_ix == nullptr && n > 0) return PyErr_NoMemory();
  Py_ssize_t* nrow_ix = row_ix + n;
  if (read_index_vec(rows, row_ix, n, n_tasks, "rows") < 0 ||
      read_index_vec(nrows, nrow_ix, n, n_nodes, "nrows") < 0)
    goto fail_ix;

  {
    /* Slot offsets for this TaskInfo type (cached across calls). */
    if (n > 0) {
      PyTypeObject* tp = Py_TYPE(PyList_GET_ITEM(tasks, row_ix[0]));
      if (g_task_slots.type != tp && resolve_slots(tp, &g_task_slots) < 0)
        goto fail_ix;
    }
    const SlotCache& sc = g_task_slots;

    /* Mutation-free prepass: homogeneous types, the volume guard, and
     * segment-count consistency — every error this function can raise
     * is guaranteed pre-mutation, which is what the caller's "the
     * prepass mutated nothing" fallback comment relies on. Counts are
     * parsed ONCE here into a C array; the mutation loop below never
     * touches the Python list again, so the guarantee is structural. */
    seg_cnt = (Py_ssize_t*)PyMem_Malloc((n_seg > 0 ? n_seg : 1) *
                                        sizeof(Py_ssize_t));
    if (seg_cnt == nullptr) {
      PyErr_NoMemory();
      goto fail_ix;
    }
    {
      Py_ssize_t total = 0;
      for (Py_ssize_t s = 0; s < n_seg; s++) {
        Py_ssize_t cnt = PyLong_AsSsize_t(PyList_GET_ITEM(counts, s));
        if (cnt == -1 && PyErr_Occurred()) goto fail_ix;
        if (cnt < 0 || cnt > n - total) {  // keeps total <= n: no overflow
          PyErr_SetString(PyExc_ValueError, "segment count out of range");
          goto fail_ix;
        }
        seg_cnt[s] = cnt;
        total += cnt;
      }
      if (total != n) {
        PyErr_SetString(PyExc_ValueError,
                        "counts do not sum to the event total");
        goto fail_ix;
      }
    }
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject* task = PyList_GET_ITEM(tasks, row_ix[i]);
      if (Py_TYPE(task) != sc.type) {
        PyErr_SetString(PyExc_TypeError, "mixed TaskInfo types in batch");
        goto fail_ix;
      }
      PyObject* uid_pre = get_slot(task, sc.off[kUid]);
      if (uid_pre == nullptr) {
        // the mutation loop uses uid as a dict key — a NULL there would
        // crash the interpreter mid-mutation
        PyErr_SetString(PyExc_AttributeError, "task.uid slot unset");
        goto fail_ix;
      }
      if (!PyUnicode_Check(uid_pre)) {
        // non-str uid could raise at hash time inside the mutation loop
        PyErr_SetString(PyExc_TypeError, "task.uid is not a str");
        goto fail_ix;
      }
      if (is_alloc[i] && !trusted) {
        PyObject* pod = get_slot(task, sc.off[kPod]);
        if (pod == nullptr) {
          PyErr_SetString(PyExc_AttributeError, "task.pod slot unset");
          goto fail_ix;
        }
        PyObject* vols = PyObject_GetAttr(pod, g_volumes_name);
        if (vols == nullptr) goto fail_ix;
        int truthy = PyObject_IsTrue(vols);
        Py_DECREF(vols);
        if (truthy < 0) goto fail_ix;
        if (truthy) {
          PyErr_SetString(PyExc_ValueError,
                          "bulk row carries volume claims (needs host-side "
                          "assume); use the Python path");
          goto fail_ix;
        }
      }
    }

    PyObject* out = PyList_New(n_seg);
    if (out == nullptr) goto fail_ix;
    Py_ssize_t i = 0;
    for (Py_ssize_t s = 0; s < n_seg; s++) {
      PyObject* alloc_d = PyDict_New();
      PyObject* pipe_d = PyDict_New();
      PyObject* pair = (alloc_d && pipe_d) ? PyTuple_Pack(2, alloc_d, pipe_d)
                                           : nullptr;
      Py_XDECREF(alloc_d);
      Py_XDECREF(pipe_d);
      if (pair == nullptr) goto fail_out;
      PyList_SET_ITEM(out, s, pair);
      Py_ssize_t end = i + seg_cnt[s];  // prepass: sums to n exactly
      for (; i < end; i++) {
        PyObject* task = PyList_GET_ITEM(tasks, row_ix[i]);
        PyObject* uid = get_slot(task, sc.off[kUid]);
        if (is_alloc[i]) {
          set_slot(task, sc.off[kVolumeReady], Py_True);
          set_slot(task, sc.off[kStatus], st_alloc);
          if (PyDict_SetItem(alloc_d, uid, task) < 0) goto fail_out;
        } else {
          set_slot(task, sc.off[kStatus], st_pipe);
          if (PyDict_SetItem(pipe_d, uid, task) < 0) goto fail_out;
        }
        set_slot(task, sc.off[kNodeName],
                 PyList_GET_ITEM(node_names, nrow_ix[i]));
        PyObject* cl = clone_slots(task, sc);
        if (cl == nullptr) goto fail_out;
        PyObject* ntd = PyList_GET_ITEM(node_tasks, nrow_ix[i]);
        int rc = PyDict_SetItem(ntd, PyList_GET_ITEM(tkeys, row_ix[i]), cl);
        Py_DECREF(cl);
        if (rc < 0) goto fail_out;
      }
    }
    PyMem_Free(seg_cnt);
    PyMem_Free(row_ix);
    return out;
  fail_out:
    Py_DECREF(out);
  }
fail_ix:
  PyMem_Free(seg_cnt);
  PyMem_Free(row_ix);
  return nullptr;
}

/* ---- Resource slot access (shared by collect_pending + extractors) ------- */

constexpr int kSlotJob = 1;
constexpr int kSlotResreq = 4;
constexpr int kSlotInitResreq = 5;

/* Resource slots (api/resource_info.py). */
constexpr int kNumResSlots = 3;
const char* const kResSlotNames[kNumResSlots] = {"milli_cpu", "memory",
                                                 "scalars"};
struct ResSlotCache {
  PyTypeObject* type = nullptr;
  Py_ssize_t off[kNumResSlots];
};
ResSlotCache g_res_slots;

int resolve_res_slots(PyTypeObject* tp, ResSlotCache* cache) {
  ResSlotCache local;  // committed atomically; see resolve_slots
  for (int i = 0; i < kNumResSlots; i++) {
    PyObject* descr = PyObject_GetAttrString((PyObject*)tp, kResSlotNames[i]);
    if (descr == nullptr) return -1;
    if (Py_TYPE(descr) != &PyMemberDescr_Type) {
      Py_DECREF(descr);
      PyErr_Format(PyExc_TypeError, "%s.%s is not a slot member",
                   tp->tp_name, kResSlotNames[i]);
      return -1;
    }
    local.off[i] = ((PyMemberDescrObject*)descr)->d_member->offset;
    Py_DECREF(descr);
  }
  local.type = tp;
  *cache = local;
  return 0;
}

/* Read resource.milli_cpu / resource.memory as doubles; -1 on error. */
inline int res_cpu_mem(PyObject* res, const ResSlotCache& rc, double* cpu,
                       double* mem) {
  PyObject* c = get_slot(res, rc.off[0]);
  PyObject* m = get_slot(res, rc.off[1]);
  if (c == nullptr || m == nullptr) {
    PyErr_SetString(PyExc_AttributeError, "Resource slot unset");
    return -1;
  }
  *cpu = PyFloat_AsDouble(c);
  if (*cpu == -1.0 && PyErr_Occurred()) return -1;
  *mem = PyFloat_AsDouble(m);
  if (*mem == -1.0 && PyErr_Occurred()) return -1;
  return 0;
}

/* ---- collect_pending ------------------------------------------------------ */

struct SortKey {
  long prio;
  double ts;
  PyObject* uid;  // borrowed
  PyObject* task; // borrowed
  char plain;
};

/* collect_pending(jobs, PENDING, eps_cpu, eps_mem, eps_scalar)
 *
 * The encoder's per-job pending extraction (ops/encode.py
 * encode_session): for each JobInfo, take task_status_index[PENDING]
 * in insertion order, drop tasks whose resreq is empty (every
 * dimension under its epsilon — resource_info.py is_empty), sort the
 * rest by (priority desc, pod creation_timestamp, uid) — the serial
 * pop order (session_plugins.go:329-341) — and classify each task as
 * "plain": no node selector, no affinity, no tolerations, no volumes,
 * a single port-less container. Plain tasks skip every per-task
 * signature/ports/label-key pass on the Python side.
 *
 * Returns list[(sorted_task_list, plain_flags_bytes)] parallel to
 * `jobs`. */
/* Interned attribute names, resolved once at module init (same pattern
 * as g_volumes_name). */
PyObject* g_idx_name = nullptr;
PyObject* g_meta_name = nullptr;
PyObject* g_ts_name = nullptr;
PyObject* g_sel_name = nullptr;
PyObject* g_aff_name = nullptr;
PyObject* g_tol_name = nullptr;
PyObject* g_cont_name = nullptr;
PyObject* g_ports_name = nullptr;

PyObject* collect_pending(PyObject*, PyObject* args) {
  PyObject *jobs, *pending_key;
  double eps_cpu, eps_mem, eps_sc;
  if (!PyArg_ParseTuple(args, "O!Oddd", &PyList_Type, &jobs, &pending_key,
                        &eps_cpu, &eps_mem, &eps_sc))
    return nullptr;

  PyObject* idx_name = g_idx_name;
  PyObject* meta_name = g_meta_name;
  PyObject* ts_name = g_ts_name;
  PyObject* sel_name = g_sel_name;
  PyObject* aff_name = g_aff_name;
  PyObject* tol_name = g_tol_name;
  PyObject* cont_name = g_cont_name;
  PyObject* ports_name = g_ports_name;

  Py_ssize_t n_jobs = PyList_GET_SIZE(jobs);
  PyObject* out = PyList_New(n_jobs);
  if (out == nullptr) return nullptr;
  std::vector<SortKey> keys;

  for (Py_ssize_t ji = 0; ji < n_jobs; ji++) {
    PyObject* job = PyList_GET_ITEM(jobs, ji);
    PyObject* sidx = PyObject_GetAttr(job, idx_name);
    if (sidx == nullptr || !PyDict_Check(sidx)) {
      Py_XDECREF(sidx);
      if (!PyErr_Occurred())
        PyErr_SetString(PyExc_TypeError, "task_status_index is not a dict");
      goto fail;
    }
    PyObject* pend = PyDict_GetItemWithError(sidx, pending_key);  // borrowed
    Py_DECREF(sidx);
    if (pend == nullptr && PyErr_Occurred()) goto fail;
    keys.clear();
    if (pend != nullptr) {
      if (!PyDict_Check(pend)) {
        PyErr_SetString(PyExc_TypeError, "status bucket is not a dict");
        goto fail;
      }
      Py_ssize_t pos = 0;
      PyObject *k, *task;
      while (PyDict_Next(pend, &pos, &k, &task)) {
        PyTypeObject* tp = Py_TYPE(task);
        if (g_task_slots.type != tp && resolve_slots(tp, &g_task_slots) < 0)
          goto fail;
        const SlotCache& sc = g_task_slots;
        PyObject* rr = get_slot(task, sc.off[kSlotResreq]);
        if (rr == nullptr) {
          PyErr_SetString(PyExc_AttributeError, "resreq slot unset");
          goto fail;
        }
        PyTypeObject* rtp = Py_TYPE(rr);
        if (g_res_slots.type != rtp &&
            resolve_res_slots(rtp, &g_res_slots) < 0)
          goto fail;
        const ResSlotCache& rc = g_res_slots;
        double cpu, mem;
        if (res_cpu_mem(rr, rc, &cpu, &mem) < 0) goto fail;
        // is_empty parity (resource_info.py): below-epsilon everywhere
        bool empty = cpu < eps_cpu && mem < eps_mem;
        PyObject* scal = get_slot(rr, rc.off[2]);
        if (empty && scal != nullptr && PyDict_Check(scal) &&
            PyDict_GET_SIZE(scal) > 0) {
          Py_ssize_t spos = 0;
          PyObject *sk, *sv;
          while (PyDict_Next(scal, &spos, &sk, &sv)) {
            double q = PyFloat_AsDouble(sv);
            if (q == -1.0 && PyErr_Occurred()) goto fail;
            if (!(q < eps_sc)) {
              empty = false;
              break;
            }
          }
        }
        if (empty) continue;  // backfill's business, not allocate's

        SortKey key;
        key.task = task;
        PyObject* pr = get_slot(task, sc.off[kPriority]);
        key.prio = pr ? PyLong_AsLong(pr) : 0;
        if (key.prio == -1 && PyErr_Occurred()) goto fail;
        key.uid = get_slot(task, sc.off[kUid]);
        if (key.uid == nullptr || !PyUnicode_Check(key.uid)) {
          PyErr_SetString(PyExc_TypeError, "task.uid is not a str");
          goto fail;
        }
        PyObject* pod = get_slot(task, sc.off[kPod]);
        if (pod == nullptr) {
          PyErr_SetString(PyExc_AttributeError, "task.pod slot unset");
          goto fail;
        }
        PyObject* meta = PyObject_GetAttr(pod, meta_name);
        PyObject* ts = meta ? PyObject_GetAttr(meta, ts_name) : nullptr;
        Py_XDECREF(meta);
        if (ts == nullptr) goto fail;
        key.ts = PyFloat_AsDouble(ts);
        Py_DECREF(ts);
        if (key.ts == -1.0 && PyErr_Occurred()) goto fail;

        // plain-ness: selector / affinity / tolerations / volumes /
        // single port-less container (mirrors _task_signature's and
        // _task_ports' fast paths)
        key.plain = 0;
        PyObject* v = PyObject_GetAttr(pod, sel_name);
        if (v == nullptr) goto fail;
        int truthy = PyObject_IsTrue(v);
        Py_DECREF(v);
        if (truthy < 0) goto fail;
        if (!truthy) {
          v = PyObject_GetAttr(pod, aff_name);
          if (v == nullptr) goto fail;
          bool aff_none = (v == Py_None);
          Py_DECREF(v);
          if (aff_none) {
            v = PyObject_GetAttr(pod, tol_name);
            if (v == nullptr) goto fail;
            truthy = PyObject_IsTrue(v);
            Py_DECREF(v);
            if (truthy < 0) goto fail;
            if (!truthy) {
              v = PyObject_GetAttr(pod, g_volumes_name);
              if (v == nullptr) goto fail;
              truthy = PyObject_IsTrue(v);
              Py_DECREF(v);
              if (truthy < 0) goto fail;
              if (!truthy) {
                PyObject* conts = PyObject_GetAttr(pod, cont_name);
                if (conts == nullptr) goto fail;
                if (PyList_Check(conts) && PyList_GET_SIZE(conts) == 1) {
                  PyObject* ports =
                      PyObject_GetAttr(PyList_GET_ITEM(conts, 0), ports_name);
                  if (ports == nullptr) {
                    Py_DECREF(conts);
                    goto fail;
                  }
                  truthy = PyObject_IsTrue(ports);
                  Py_DECREF(ports);
                  if (truthy < 0) {
                    Py_DECREF(conts);
                    goto fail;
                  }
                  key.plain = truthy ? 0 : 1;
                }
                Py_DECREF(conts);
              }
            }
          }
        }
        keys.push_back(key);
      }
    }
    // (priority desc, creation_timestamp, uid) — stable, uid last
    std::stable_sort(keys.begin(), keys.end(),
                     [](const SortKey& a, const SortKey& b) {
                       if (a.prio != b.prio) return a.prio > b.prio;
                       if (a.ts != b.ts) return a.ts < b.ts;
                       return PyUnicode_Compare(a.uid, b.uid) < 0;
                     });
    {
      Py_ssize_t m = (Py_ssize_t)keys.size();
      PyObject* tl = PyList_New(m);
      PyObject* flags = PyBytes_FromStringAndSize(nullptr, m);
      if (tl == nullptr || flags == nullptr) {
        Py_XDECREF(tl);
        Py_XDECREF(flags);
        goto fail;
      }
      char* fb = PyBytes_AS_STRING(flags);
      for (Py_ssize_t i = 0; i < m; i++) {
        Py_INCREF(keys[i].task);
        PyList_SET_ITEM(tl, i, keys[i].task);
        fb[i] = keys[i].plain;
      }
      PyObject* pair = PyTuple_Pack(2, tl, flags);
      Py_DECREF(tl);
      Py_DECREF(flags);
      if (pair == nullptr) goto fail;
      PyList_SET_ITEM(out, ji, pair);
    }
  }
  return out;
fail:
  Py_DECREF(out);
  return nullptr;
}

/* ---- encode-side extractors ---------------------------------------------- */

struct F32F64Buf {
  Py_buffer view{};
  bool is_f64 = false;
  bool ok = false;
};

/* Acquire a writable C-contiguous float32/float64 buffer. */
bool get_float_buf(PyObject* obj, F32F64Buf* b, int want_ndim) {
  if (PyObject_GetBuffer(obj, &b->view, PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE |
                                            PyBUF_FORMAT) < 0)
    return false;
  b->ok = true;
  const char* f = b->view.format;
  if (b->view.ndim != want_ndim || f == nullptr ||
      !((f[0] == 'f' || f[0] == 'd') && f[1] == '\0')) {
    PyErr_SetString(PyExc_TypeError,
                    "expected a C-contiguous float32/float64 buffer");
    return false;
  }
  b->is_f64 = b->view.format[0] == 'd';
  return true;
}

inline void put_f(const F32F64Buf& b, Py_ssize_t flat_ix, double v) {
  if (b.is_f64)
    ((double*)b.view.buf)[flat_ix] = v;
  else
    ((float*)b.view.buf)[flat_ix] = (float)v;
}

/* extract_task_columns(tasks, job_idx, req, res, job_out, has_sc,
 *                      res_has_sc)
 *
 * The scalar-less encoder fast path (ops/encode.py): for task i write
 *   req[i,0:2]  = init_resreq.{milli_cpu,memory}
 *   res[i,0:2]  = resreq.{milli_cpu,memory}
 *   job_out[i]  = job_idx[task.job]          (int32)
 *   has_sc[i]   = bool(init_resreq.scalars)  (uint8/bool)
 *   res_has_sc[i] = bool(resreq.scalars)
 * req/res are the [T,R] padded arrays (T >= len(tasks)); only the first
 * len(tasks) rows and two columns are touched. */
PyObject* extract_task_columns(PyObject*, PyObject* args) {
  PyObject *tasks, *job_idx, *req_o, *res_o, *job_o, *hs_o, *rhs_o;
  if (!PyArg_ParseTuple(args, "O!O!OOOOO", &PyList_Type, &tasks, &PyDict_Type,
                        &job_idx, &req_o, &res_o, &job_o, &hs_o, &rhs_o))
    return nullptr;

  F32F64Buf req, res;
  Py_buffer job_b{}, hs_b{}, rhs_b{};
  bool job_ok = false, hs_ok = false, rhs_ok = false;
  PyObject* ret = nullptr;
  Py_ssize_t n = PyList_GET_SIZE(tasks);

  if (!get_float_buf(req_o, &req, 2) || !get_float_buf(res_o, &res, 2))
    goto done;
  if (PyObject_GetBuffer(job_o, &job_b,
                         PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE | PyBUF_FORMAT) <
      0)
    goto done;
  job_ok = true;
  if (PyObject_GetBuffer(hs_o, &hs_b,
                         PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE | PyBUF_FORMAT) <
      0)
    goto done;
  hs_ok = true;
  if (PyObject_GetBuffer(rhs_o, &rhs_b,
                         PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE | PyBUF_FORMAT) <
      0)
    goto done;
  rhs_ok = true;

  if (job_b.itemsize != 4 || hs_b.itemsize != 1 || rhs_b.itemsize != 1 ||
      req.view.shape[0] < n || res.view.shape[0] < n || job_b.len < 4 * n ||
      hs_b.len < n || rhs_b.len < n || req.view.shape[1] < 2 ||
      res.view.shape[1] < 2) {
    PyErr_SetString(PyExc_ValueError, "output buffer shape/dtype mismatch");
    goto done;
  }

  {
    Py_ssize_t req_R = req.view.shape[1], res_R = res.view.shape[1];
    int32_t* job_out = (int32_t*)job_b.buf;
    char* hs = (char*)hs_b.buf;
    char* rhs = (char*)rhs_b.buf;
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject* task = PyList_GET_ITEM(tasks, i);
      PyTypeObject* tp = Py_TYPE(task);
      if (g_task_slots.type != tp && resolve_slots(tp, &g_task_slots) < 0)
        goto done;
      const SlotCache& sc = g_task_slots;
      PyObject* rr = get_slot(task, sc.off[kSlotResreq]);
      PyObject* ir = get_slot(task, sc.off[kSlotInitResreq]);
      if (rr == nullptr || ir == nullptr) {
        PyErr_SetString(PyExc_AttributeError, "task resource slot unset");
        goto done;
      }
      PyTypeObject* rtp = Py_TYPE(rr);
      if (g_res_slots.type != rtp && resolve_res_slots(rtp, &g_res_slots) < 0)
        goto done;
      if (Py_TYPE(ir) != g_res_slots.type) {
        PyErr_SetString(PyExc_TypeError, "mixed Resource types");
        goto done;
      }
      const ResSlotCache& rc = g_res_slots;
      double cpu, mem;
      if (res_cpu_mem(ir, rc, &cpu, &mem) < 0) goto done;
      put_f(req, i * req_R + 0, cpu);
      put_f(req, i * req_R + 1, mem);
      if (res_cpu_mem(rr, rc, &cpu, &mem) < 0) goto done;
      put_f(res, i * res_R + 0, cpu);
      put_f(res, i * res_R + 1, mem);
      PyObject* jid = get_slot(task, sc.off[kSlotJob]);
      PyObject* jrow = jid ? PyDict_GetItemWithError(job_idx, jid) : nullptr;
      if (jrow == nullptr) {
        if (!PyErr_Occurred())
          PyErr_SetString(PyExc_KeyError, "task.job not in job_idx");
        goto done;
      }
      long j = PyLong_AsLong(jrow);
      if (j == -1 && PyErr_Occurred()) goto done;
      job_out[i] = (int32_t)j;
      PyObject* ir_sc = get_slot(ir, rc.off[2]);
      PyObject* rr_sc = get_slot(rr, rc.off[2]);
      if (ir_sc == nullptr || rr_sc == nullptr) {
        PyErr_SetString(PyExc_AttributeError, "Resource scalars slot unset");
        goto done;
      }
      int t1 = PyObject_IsTrue(ir_sc);
      int t2 = PyObject_IsTrue(rr_sc);
      if (t1 < 0 || t2 < 0) goto done;
      hs[i] = (char)t1;
      rhs[i] = (char)t2;
    }
  }
  ret = Py_NewRef(Py_None);

done:
  if (req.ok) PyBuffer_Release(&req.view);
  if (res.ok) PyBuffer_Release(&res.view);
  if (job_ok) PyBuffer_Release(&job_b);
  if (hs_ok) PyBuffer_Release(&hs_b);
  if (rhs_ok) PyBuffer_Release(&rhs_b);
  return ret;
}

/* extract_node_columns(nodes, names, out) — the node-side scalar-less
 * fast path: nodes is list[NodeInfo], names a tuple of attribute names
 * (e.g. ("idle","releasing","used","allocatable")), out a writable
 * [len(names), N, R] float buffer; writes out[a, i, 0:2] =
 * node.<names[a]>.{milli_cpu,memory}. */
PyObject* extract_node_columns(PyObject*, PyObject* args) {
  PyObject *nodes, *names, *out_o;
  if (!PyArg_ParseTuple(args, "O!O!O", &PyList_Type, &nodes, &PyTuple_Type,
                        &names, &out_o))
    return nullptr;
  F32F64Buf out;
  PyObject* ret = nullptr;
  Py_ssize_t n = PyList_GET_SIZE(nodes);
  Py_ssize_t na = PyTuple_GET_SIZE(names);
  if (PyObject_GetBuffer(out_o, &out.view, PyBUF_C_CONTIGUOUS |
                                               PyBUF_WRITABLE | PyBUF_FORMAT) <
      0)
    return nullptr;
  out.ok = true;
  {
    const char* f = out.view.format;
    if (out.view.ndim != 3 || f == nullptr ||
        !((f[0] == 'f' || f[0] == 'd') && f[1] == '\0') ||
        out.view.shape[0] != na || out.view.shape[1] < n ||
        out.view.shape[2] < 2) {
      PyErr_SetString(PyExc_ValueError, "output buffer shape/dtype mismatch");
      goto done;
    }
    out.is_f64 = f[0] == 'd';
    Py_ssize_t N = out.view.shape[1], R = out.view.shape[2];
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject* node = PyList_GET_ITEM(nodes, i);
      for (Py_ssize_t a = 0; a < na; a++) {
        PyObject* res = PyObject_GetAttr(node, PyTuple_GET_ITEM(names, a));
        if (res == nullptr) goto done;
        PyTypeObject* rtp = Py_TYPE(res);
        if (g_res_slots.type != rtp &&
            resolve_res_slots(rtp, &g_res_slots) < 0) {
          Py_DECREF(res);
          goto done;
        }
        double cpu, mem;
        int rc = res_cpu_mem(res, g_res_slots, &cpu, &mem);
        Py_DECREF(res);
        if (rc < 0) goto done;
        put_f(out, (a * N + i) * R + 0, cpu);
        put_f(out, (a * N + i) * R + 1, mem);
      }
    }
  }
  ret = Py_NewRef(Py_None);
done:
  PyBuffer_Release(&out.view);
  return ret;
}

/* ---- bulk_set_slot ------------------------------------------------------- */

/* bulk_set_slot(objs, name, value): obj.<name> = value for every obj —
 * the gang-dispatch status flip (finish()) without 100k interpreter
 * stores. Objects must share one __slots__ type. */
PyObject* bulk_set_slot(PyObject*, PyObject* args) {
  PyObject *objs, *name, *value;
  if (!PyArg_ParseTuple(args, "O!UO", &PyList_Type, &objs, &name, &value))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(objs);
  if (n == 0) Py_RETURN_NONE;
  PyTypeObject* tp = Py_TYPE(PyList_GET_ITEM(objs, 0));
  PyObject* descr = PyObject_GetAttr((PyObject*)tp, name);
  if (descr == nullptr) return nullptr;
  if (Py_TYPE(descr) != &PyMemberDescr_Type) {
    Py_DECREF(descr);
    PyErr_Format(PyExc_TypeError, "%s.%U is not a slot member", tp->tp_name,
                 name);
    return nullptr;
  }
  Py_ssize_t off = ((PyMemberDescrObject*)descr)->d_member->offset;
  Py_DECREF(descr);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* o = PyList_GET_ITEM(objs, i);
    if (Py_TYPE(o) != tp) {
      PyErr_SetString(PyExc_TypeError, "mixed object types in batch");
      return nullptr;
    }
    set_slot(o, off, value);
  }
  Py_RETURN_NONE;
}

/* ---- bulk_dispatch ------------------------------------------------------- */

/* bulk_dispatch(jobs, mask, ALLOCATED, BINDING) -> list[task]
 *
 * The gang dispatch barrier's pure-bulk half (torch_allocate finish()):
 * for each job whose mask byte is 1, move task_status_index[ALLOCATED]
 * wholesale under [BINDING] and append the moved tasks (index insertion
 * order) to the returned flat list. When no BINDING bucket exists the
 * dict itself moves — one setitem+delitem per GANG, not per task. The
 * caller owns the readiness/purity decisions baked into mask and flips
 * the returned tasks' status afterwards (bulk_set_slot). */
PyObject* bulk_dispatch(PyObject*, PyObject* args) {
  PyObject *jobs, *mask_b, *alloc_key, *binding_key;
  if (!PyArg_ParseTuple(args, "O!SOO", &PyList_Type, &jobs, &mask_b,
                        &alloc_key, &binding_key))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(jobs);
  if (PyBytes_GET_SIZE(mask_b) != n) {
    PyErr_SetString(PyExc_ValueError, "mask length mismatch");
    return nullptr;
  }
  const char* mask = PyBytes_AS_STRING(mask_b);
  /* Mutation-free prepass: every masked job must expose a dict status
   * index BEFORE any bucket moves — the caller's Python fallback
   * re-walks all jobs assuming nothing was dispatched yet; a mid-loop
   * failure after partial moves would strand those gangs unbound. */
  for (Py_ssize_t i = 0; i < n; i++) {
    if (!mask[i]) continue;
    PyObject* sidx = PyObject_GetAttr(PyList_GET_ITEM(jobs, i), g_idx_name);
    if (sidx == nullptr) return nullptr;
    int ok = PyDict_Check(sidx);
    Py_DECREF(sidx);
    if (!ok) {
      PyErr_SetString(PyExc_TypeError, "task_status_index is not a dict");
      return nullptr;
    }
  }
  PyObject* out = PyList_New(0);
  if (out == nullptr) return nullptr;
  for (Py_ssize_t i = 0; i < n; i++) {
    if (!mask[i]) continue;
    PyObject* sidx = PyObject_GetAttr(PyList_GET_ITEM(jobs, i), g_idx_name);
    if (sidx == nullptr) goto fail;
    if (!PyDict_Check(sidx)) {
      Py_DECREF(sidx);
      PyErr_SetString(PyExc_TypeError, "task_status_index is not a dict");
      goto fail;
    }
    {
      PyObject* allocated = PyDict_GetItemWithError(sidx, alloc_key);
      if (allocated == nullptr) {
        Py_DECREF(sidx);
        if (PyErr_Occurred()) goto fail;
        continue;  // nothing Allocated on this job
      }
      if (!PyDict_Check(allocated) || PyDict_GET_SIZE(allocated) == 0) {
        Py_DECREF(sidx);
        continue;
      }
      Py_ssize_t pos = 0;
      PyObject *k, *task;
      while (PyDict_Next(allocated, &pos, &k, &task)) {
        if (PyList_Append(out, task) < 0) {
          Py_DECREF(sidx);
          goto fail;
        }
      }
      PyObject* binding = PyDict_GetItemWithError(sidx, binding_key);
      int rc;
      if (binding == nullptr) {
        if (PyErr_Occurred()) {
          Py_DECREF(sidx);
          goto fail;
        }
        rc = PyDict_SetItem(sidx, binding_key, allocated);  // dict moves
      } else {
        rc = PyDict_Merge(binding, allocated, 1);
      }
      if (rc == 0) rc = PyDict_DelItem(sidx, alloc_key);
      Py_DECREF(sidx);
      if (rc < 0) goto fail;
    }
  }
  return out;
fail:
  Py_DECREF(out);
  return nullptr;
}

/* ---- finish_columns ------------------------------------------------------ */

/* finish_columns(tasks, row_of, task_keys, new_status) ->
 *     (rows_bytes int64, created_bytes f64, keys list, hostnames list)
 *
 * One C pass over the dispatch list building everything finish() needs:
 * per task its encoder row (-1 if this encode never saw it), its pod
 * creation timestamp, its "ns/name" bind key (borrowed from task_keys
 * when encoded, built fresh otherwise) and its node_name — replacing
 * four separate 200k-iteration Python comprehensions on the replay's
 * critical path. When ``new_status`` is not None every task's status
 * slot is set to it in the same pass (the gang-dispatch flip; nothing
 * observes status between the dispatch loop and the bind). */
PyObject* finish_columns(PyObject*, PyObject* args) {
  PyObject *tasks, *row_of, *task_keys, *new_status;
  if (!PyArg_ParseTuple(args, "O!O!O!O", &PyList_Type, &tasks, &PyDict_Type,
                        &row_of, &PyList_Type, &task_keys, &new_status))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(tasks);
  Py_ssize_t n_keys = PyList_GET_SIZE(task_keys);
  PyObject *rows_b = nullptr, *created_b = nullptr, *keys = nullptr,
           *hostnames = nullptr, *out = nullptr;
  rows_b = PyBytes_FromStringAndSize(nullptr, n * (Py_ssize_t)sizeof(int64_t));
  created_b = PyBytes_FromStringAndSize(nullptr, n * (Py_ssize_t)sizeof(double));
  keys = PyList_New(n);
  hostnames = PyList_New(n);
  if (!rows_b || !created_b || !keys || !hostnames) goto fail;
  {
    int64_t* rows = (int64_t*)PyBytes_AS_STRING(rows_b);
    double* created = (double*)PyBytes_AS_STRING(created_b);
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject* task = PyList_GET_ITEM(tasks, i);
      PyTypeObject* tp = Py_TYPE(task);
      if (g_task_slots.type != tp && resolve_slots(tp, &g_task_slots) < 0)
        goto fail;
      const SlotCache& sc = g_task_slots;
      PyObject* uid = get_slot(task, sc.off[kUid]);
      if (uid == nullptr) {
        PyErr_SetString(PyExc_AttributeError, "task.uid slot unset");
        goto fail;
      }
      PyObject* row_o = PyDict_GetItemWithError(row_of, uid);
      if (row_o == nullptr && PyErr_Occurred()) goto fail;
      Py_ssize_t row = -1;
      if (row_o != nullptr) {
        row = PyLong_AsSsize_t(row_o);
        if (row == -1 && PyErr_Occurred()) goto fail;
      }
      rows[i] = (int64_t)row;
      PyObject* pod = get_slot(task, sc.off[kPod]);
      if (pod == nullptr) {
        PyErr_SetString(PyExc_AttributeError, "task.pod slot unset");
        goto fail;
      }
      PyObject* meta = PyObject_GetAttr(pod, g_meta_name);
      PyObject* ts = meta ? PyObject_GetAttr(meta, g_ts_name) : nullptr;
      Py_XDECREF(meta);
      if (ts == nullptr) goto fail;
      created[i] = PyFloat_AsDouble(ts);
      Py_DECREF(ts);
      if (created[i] == -1.0 && PyErr_Occurred()) goto fail;
      PyObject* key;
      if (row >= 0 && row < n_keys) {
        key = Py_NewRef(PyList_GET_ITEM(task_keys, row));
      } else {
        PyObject* ns = get_slot(task, sc.off[kNamespace]);
        PyObject* nm = get_slot(task, sc.off[kName]);
        if (ns == nullptr || nm == nullptr) {
          PyErr_SetString(PyExc_AttributeError, "task ns/name slot unset");
          goto fail;
        }
        key = PyUnicode_FromFormat("%U/%U", ns, nm);
        if (key == nullptr) goto fail;
      }
      PyList_SET_ITEM(keys, i, key);
      PyObject* node_name = get_slot(task, sc.off[kNodeName]);
      if (node_name == nullptr) {
        PyErr_SetString(PyExc_AttributeError, "task.node_name slot unset");
        goto fail;
      }
      PyList_SET_ITEM(hostnames, i, Py_NewRef(node_name));
      if (new_status != Py_None) set_slot(task, sc.off[kStatus], new_status);
    }
  }
  out = PyTuple_Pack(4, rows_b, created_b, keys, hostnames);
fail:
  Py_XDECREF(rows_b);
  Py_XDECREF(created_b);
  Py_XDECREF(keys);
  Py_XDECREF(hostnames);
  return out;
}

/* ---- bulk_res_axpy ------------------------------------------------------- */

/* bulk_res_axpy(res_objs, deltas, sign): for each Resource object,
 *   milli_cpu += sign * deltas[i,0];  memory += sign * deltas[i,1]
 * (deltas a C-contiguous [n,>=2] float64 buffer). The scalar-map
 * dimensions keep their Go nil-map semantics on the Python side — this
 * covers only the two dense dimensions every node/job touches. */
PyObject* bulk_res_axpy(PyObject*, PyObject* args) {
  PyObject *objs, *buf_o;
  int sign;
  if (!PyArg_ParseTuple(args, "O!Oi", &PyList_Type, &objs, &buf_o, &sign))
    return nullptr;
  Py_buffer view;
  if (PyObject_GetBuffer(buf_o, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
    return nullptr;
  PyObject* ret = nullptr;
  {
    Py_ssize_t n = PyList_GET_SIZE(objs);
    if (view.ndim != 2 || view.shape[0] < n || view.shape[1] < 2 ||
        view.itemsize != 8 || view.format == nullptr ||
        view.format[0] != 'd') {
      PyErr_SetString(PyExc_TypeError, "deltas must be [n,>=2] float64");
      goto done;
    }
    Py_ssize_t R = view.shape[1];
    const double* d = (const double*)view.buf;
    /* Mutation-free prepass: one homogeneous slot type, both dense
     * slots set on every element — a heterogeneous Resource variant
     * raises BEFORE any pool is touched. The caller's per-pool Python
     * fallback relies on failures being pre-mutation (a half-applied
     * delta would double-count under the fallback). */
    if (n > 0) {
      PyTypeObject* rtp = Py_TYPE(PyList_GET_ITEM(objs, 0));
      if (g_res_slots.type != rtp && resolve_res_slots(rtp, &g_res_slots) < 0)
        goto done;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject* res = PyList_GET_ITEM(objs, i);
      if (Py_TYPE(res) != g_res_slots.type) {
        PyErr_SetString(PyExc_TypeError, "mixed Resource types in batch");
        goto done;
      }
      double cpu, mem;  // also proves float-convertibility pre-mutation
      if (res_cpu_mem(res, g_res_slots, &cpu, &mem) < 0) goto done;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject* res = PyList_GET_ITEM(objs, i);
      const ResSlotCache& rc = g_res_slots;
      double cpu, mem;
      if (res_cpu_mem(res, rc, &cpu, &mem) < 0) goto done;
      PyObject* nc = PyFloat_FromDouble(cpu + sign * d[i * R + 0]);
      if (nc == nullptr) goto done;
      set_slot(res, rc.off[0], nc);
      Py_DECREF(nc);
      PyObject* nm = PyFloat_FromDouble(mem + sign * d[i * R + 1]);
      if (nm == nullptr) goto done;
      set_slot(res, rc.off[1], nm);
      Py_DECREF(nm);
    }
    ret = Py_NewRef(Py_None);
  }
done:
  PyBuffer_Release(&view);
  return ret;
}

/* ---- class_dedup --------------------------------------------------------- */

/* Shared hash pass over T rows of row_bytes each at base (C-contiguous
 * concatenated key matrix): classes numbered in FIRST-OCCURRENCE order.
 * Returns PyTuple (first int64 bytes, inverse int32 bytes) or nullptr. */
static PyObject* dedup_pass(const char* base, Py_ssize_t T,
                            Py_ssize_t row_bytes) {
  PyObject *first_b = nullptr, *inv_b = nullptr, *out = nullptr;
  inv_b = PyBytes_FromStringAndSize(nullptr, T * (Py_ssize_t)sizeof(int32_t));
  if (inv_b == nullptr) return nullptr;
  int32_t* inv = (int32_t*)PyBytes_AS_STRING(inv_b);
  std::vector<int64_t> first;
  first.reserve(256);
  {
    std::unordered_map<std::string_view, int32_t> seen;
    seen.reserve((size_t)T * 2);
    for (Py_ssize_t i = 0; i < T; i++) {
      std::string_view row(base + i * row_bytes, (size_t)row_bytes);
      auto [it, inserted] = seen.emplace(row, (int32_t)first.size());
      if (inserted) first.push_back((int64_t)i);
      inv[i] = it->second;
    }
  }
  first_b = PyBytes_FromStringAndSize((const char*)first.data(),
                                      first.size() * sizeof(int64_t));
  if (first_b != nullptr) out = PyTuple_Pack(2, first_b, inv_b);
  Py_XDECREF(first_b);
  Py_DECREF(inv_b);
  return out;
}

/* class_dedup(keys) -> (first_bytes, inverse_bytes)
 *
 * Row-dedup of a C-contiguous 2-D buffer (any fixed-size dtype): one
 * O(T) hash pass over row byte-spans, classes numbered in
 * FIRST-OCCURRENCE order. Replaces np.unique's O(T log T) void-sort in
 * the encoder's task-class dedup (ops/fused_solve._class_inverse) —
 * the difference is ~0.3 s at 400k tasks. Returns two bytes objects the
 * caller np.frombuffer's: first (int64 row index per class) and inverse
 * (int32 class id per row). Any consistent (first, inverse) pairing is
 * valid for the kernel packing; class order itself carries no meaning.
 *
 * Arbitrary-width keys: a tuple/list of 2-D buffers sharing shape[0]
 * dedups over their per-row byte concatenation — the class-solve node
 * key can span several dtype-mixed slabs, and
 * concatenating them byte-wise here (one scratch fill, no numpy
 * round-trip) keeps the multi-slab form one O(N * key_bytes) pass. */
PyObject* class_dedup(PyObject*, PyObject* arg) {
  if (PyTuple_Check(arg) || PyList_Check(arg)) {
    Py_ssize_t nbuf = PySequence_Fast_GET_SIZE(arg);
    if (nbuf == 0) {
      PyErr_SetString(PyExc_TypeError,
                      "class_dedup needs at least one 2-D buffer");
      return nullptr;
    }
    std::vector<Py_buffer> views((size_t)nbuf);
    Py_ssize_t got = 0;
    PyObject* out = nullptr;
    Py_ssize_t T = 0, row_bytes = 0;
    for (; got < nbuf; got++) {
      PyObject* item = PySequence_Fast_GET_ITEM(arg, got);
      if (PyObject_GetBuffer(item, &views[got],
                             PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
        goto multi_done;
      if (views[got].ndim != 2) {
        PyErr_SetString(PyExc_TypeError,
                        "class_dedup needs 2-D buffers in the key tuple");
        got++;
        goto multi_done;
      }
      if (got == 0) {
        T = views[0].shape[0];
      } else if (views[got].shape[0] != T) {
        PyErr_SetString(PyExc_ValueError,
                        "class_dedup key buffers disagree on row count");
        got++;
        goto multi_done;
      }
      row_bytes += views[got].shape[1] * views[got].itemsize;
    }
    {
      /* per-row byte concat into one scratch matrix, then the same pass */
      std::vector<char> scratch((size_t)(T * row_bytes));
      Py_ssize_t col = 0;
      for (Py_ssize_t b = 0; b < nbuf; b++) {
        Py_ssize_t seg = views[b].shape[1] * views[b].itemsize;
        const char* src = (const char*)views[b].buf;
        char* dst = scratch.data() + col;
        for (Py_ssize_t i = 0; i < T; i++)
          std::memcpy(dst + i * row_bytes, src + i * seg, (size_t)seg);
        col += seg;
      }
      out = dedup_pass(scratch.data(), T, row_bytes);
    }
  multi_done:
    for (Py_ssize_t b = 0; b < got; b++) PyBuffer_Release(&views[b]);
    return out;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
    return nullptr;
  PyObject* out = nullptr;
  if (view.ndim != 2) {
    PyErr_SetString(PyExc_TypeError, "class_dedup needs a 2-D buffer");
  } else {
    out = dedup_pass((const char*)view.buf, view.shape[0],
                     view.shape[1] * view.itemsize);
  }
  PyBuffer_Release(&view);
  return out;
}

/* ---- module -------------------------------------------------------------- */

PyMethodDef methods[] = {
    {"bulk_assign", bulk_assign, METH_VARARGS,
     "Apply kernel assignment events to session TaskInfo/node state."},
    {"bulk_set_slot", bulk_set_slot, METH_VARARGS,
     "Set one __slots__ attribute on every object in a list."},
    {"collect_pending", collect_pending, METH_VARARGS,
     "Per-job pending extraction: filter empties, pop-order sort, "
     "plain-task classification."},
    {"extract_task_columns", extract_task_columns, METH_VARARGS,
     "Fill SoA request/limit/job/scalar-flag columns from TaskInfos."},
    {"extract_node_columns", extract_node_columns, METH_VARARGS,
     "Fill [A,N,R] cpu/mem columns from NodeInfo resource attributes."},
    {"class_dedup", class_dedup, METH_O,
     "Row-dedup a 2-D buffer, or a tuple/list of 2-D buffers sharing "
     "shape[0] (byte-concatenated per row): (first int64 bytes, "
     "inverse int32 bytes)."},
    {"bulk_dispatch", bulk_dispatch, METH_VARARGS,
     "Move masked jobs' ALLOCATED buckets under BINDING; return the tasks."},
    {"finish_columns", finish_columns, METH_VARARGS,
     "Rows/created/keys/pairs for the dispatch list in one pass."},
    {"bulk_res_axpy", bulk_res_axpy, METH_VARARGS,
     "Resource.milli_cpu/memory += sign*deltas[i] over a list."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hotloops",
    "Native bulk session-mutation loops (see module docstring in source).",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__hotloops(void) {
  g_volumes_name = PyUnicode_InternFromString("volumes");
  g_idx_name = PyUnicode_InternFromString("task_status_index");
  g_meta_name = PyUnicode_InternFromString("metadata");
  g_ts_name = PyUnicode_InternFromString("creation_timestamp");
  g_sel_name = PyUnicode_InternFromString("node_selector");
  g_aff_name = PyUnicode_InternFromString("affinity");
  g_tol_name = PyUnicode_InternFromString("tolerations");
  g_cont_name = PyUnicode_InternFromString("containers");
  g_ports_name = PyUnicode_InternFromString("ports");
  if (!g_volumes_name || !g_idx_name || !g_meta_name || !g_ts_name ||
      !g_sel_name || !g_aff_name || !g_tol_name || !g_cont_name ||
      !g_ports_name)
    return nullptr;
  return PyModule_Create(&moduledef);
}
