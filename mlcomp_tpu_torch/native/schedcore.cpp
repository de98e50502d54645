// Native scheduler core: per-tick DAG analysis (ready set + doom
// propagation) in one O(V+E) pass.
//
// The reference's Supervisor re-derives schedulable work from task state
// every tick; mlcomp_tpu's Supervisor does the same against the sqlite
// store (scheduler/supervisor.py).  Grid-search DAGs expand to thousands
// of tasks, and the Python doom-propagation loop (dag/graph.py
// doomed_tasks) is O(V*E) with dict lookups per edge.  This kernel does
// one Kahn pass over a prebuilt CSR: topological order, doom propagation
// (a NOT_RAN node with any failed/skipped/stopped or doomed dependency is
// doomed), and the ready set (NOT_RAN, all deps SUCCESS), sorted by
// (-priority, index) so higher-priority work queues first.
//
// Status codes (Python side maps TaskStatus): 0 = not_ran, 1 = pending
// (queued/in_progress), 2 = success, 3 = failed/skipped/stopped.
//
// Build: compiled into libmlcdata.so together with dataops.cpp.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// dep_off/deps: CSR of each node's dependency list (dep_off has n+1
// entries).  ready_out/doomed_out must each hold n entries.  Returns the
// ready count (>=0) and writes the doomed count through doomed_count;
// returns -1 if the graph has a cycle (defensive — DAGs are validated at
// submit time).
int64_t mlc_dag_analyze(int64_t n, const int64_t* dep_off,
                        const int64_t* deps, const int8_t* status,
                        const int64_t* prio, int64_t* ready_out,
                        int64_t* doomed_out, int64_t* doomed_count) {
  *doomed_count = 0;
  if (n <= 0) return 0;

  // dependents (reverse CSR) + indegrees for Kahn
  std::vector<int64_t> out_deg(n, 0), indeg(n, 0);
  for (int64_t v = 0; v < n; ++v) {
    indeg[v] = dep_off[v + 1] - dep_off[v];
    for (int64_t e = dep_off[v]; e < dep_off[v + 1]; ++e) ++out_deg[deps[e]];
  }
  std::vector<int64_t> radj_off(n + 1, 0);
  for (int64_t v = 0; v < n; ++v) radj_off[v + 1] = radj_off[v] + out_deg[v];
  std::vector<int64_t> radj(radj_off[n]);
  std::vector<int64_t> cursor(radj_off.begin(), radj_off.end() - 1);
  for (int64_t v = 0; v < n; ++v)
    for (int64_t e = dep_off[v]; e < dep_off[v + 1]; ++e)
      radj[cursor[deps[e]]++] = v;

  // Kahn topological order
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> q;
  q.reserve(n);
  for (int64_t v = 0; v < n; ++v)
    if (indeg[v] == 0) q.push_back(v);
  for (size_t h = 0; h < q.size(); ++h) {
    int64_t u = q[h];
    order.push_back(u);
    for (int64_t e = radj_off[u]; e < radj_off[u + 1]; ++e)
      if (--indeg[radj[e]] == 0) q.push_back(radj[e]);
  }
  if ((int64_t)order.size() != n) return -1;  // cycle

  // doom propagation in topo order (deps visited before dependents)
  std::vector<int8_t> doomed(n, 0);
  for (int64_t u : order) {
    if (status[u] != 0) continue;  // only NOT_RAN nodes can become doomed
    for (int64_t e = dep_off[u]; e < dep_off[u + 1]; ++e) {
      int64_t d = deps[e];
      if (status[d] == 3 || doomed[d]) {
        doomed[u] = 1;
        doomed_out[(*doomed_count)++] = u;
        break;
      }
    }
  }

  // ready set: NOT_RAN, every dep SUCCESS
  int64_t n_ready = 0;
  for (int64_t v = 0; v < n; ++v) {
    if (status[v] != 0 || doomed[v]) continue;
    bool ok = true;
    for (int64_t e = dep_off[v]; e < dep_off[v + 1]; ++e)
      if (status[deps[e]] != 2) {
        ok = false;
        break;
      }
    if (ok) ready_out[n_ready++] = v;
  }
  std::sort(ready_out, ready_out + n_ready, [&](int64_t a, int64_t b) {
    if (prio[a] != prio[b]) return prio[a] > prio[b];
    return a < b;
  });
  return n_ready;
}

}  // extern "C"
