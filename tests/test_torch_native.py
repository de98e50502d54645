"""The port's native data-ops library (``mlcomp_tpu_torch/native``)
against the JAX package's (``mlcomp_tpu/native``) on the same inputs and
seeds: the GIL-free gather, the Fisher-Yates shuffle, the loader's batch
order under ``MLCOMP_TPU_NATIVE_SHUFFLE`` and the DAG analyzer's one-pass
ready/doomed walk, each also against numpy or the Python walk.  Skipped
only where ``g++`` is absent, as tests/test_native.py skips.
"""

import numpy as np
import pytest
import torch

from mlcomp_tpu import native as jnative
from mlcomp_tpu_torch import native

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    lib, jlib = native.lib(), jnative.lib()
    if lib is None or jlib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_the_library_builds_from_the_ports_sources_into_the_build_dir(built):
    """Built with g++ into the git-ignored ``_build``, keyed on the
    sources; never next to the sources, never the JAX package's
    committed ``.so``; the sources are the reference's."""
    import mlcomp_tpu_torch

    so = native.so_path()
    assert so.exists() and so.parent.parent.name == "_build"
    assert so.parent.parent.parent.name == "mlcomp_tpu_torch"
    assert built._name == str(so)
    assert not list(so.parent.parent.parent.joinpath("native").glob("*.so"))
    from pathlib import Path

    ref = Path(jnative.__file__).parent
    port = Path(mlcomp_tpu_torch.__file__).parent / "native"
    for src in ("dataops.cpp", "schedcore.cpp"):
        assert (port / src).read_bytes() == (ref / src).read_bytes()


@pytest.mark.parametrize("shape,dtype,n_idx,threads", [
    ((64, 7, 3), np.float32, 32, None), ((512, 1024), np.float32, 512, 4),
    ((100,), np.int32, 4, None), ((33, 5), np.uint8, 70, 2), ((9, 2, 2), np.float64, 0, None)])
def test_gather_equals_numpy_and_the_jax_gather(built, shape, dtype, n_idx, threads):
    rs = np.random.RandomState(0)
    src = (rs.rand(*shape) * 100).astype(dtype)
    idx = rs.randint(0, shape[0], size=n_idx)
    got = native.gather_rows(src, idx, n_threads=threads)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, jnative.gather_rows(src, idx, n_threads=threads))
    assert got.dtype == src.dtype and got.shape == (n_idx,) + shape[1:]


def test_gather_takes_negative_indices_and_refuses_out_of_range_ones(built):
    """numpy's semantics, which the numpy fallback has: a negative index
    counts from the end; one out of range raises rather than reading
    past the array."""
    src = np.arange(20, dtype=np.int64).reshape(10, 2)
    np.testing.assert_array_equal(native.gather_rows(src, np.array([-1, 0, -10])),
                                  src[[-1, 0, -10]])
    for bad in ([10], [-11]):
        with pytest.raises(IndexError):
            native.gather_rows(src, np.array(bad))
    assert native.gather_rows(np.asfortranarray(src), np.array([0])) is None


@pytest.mark.parametrize("n,seed", [(1000, 7), (1, 0), (37, 2**40 + 3), (0, 5)])
def test_shuffle_equals_the_jax_shuffle(built, n, seed):
    a = native.shuffled_indices(n, seed=seed)
    assert sorted(a.tolist()) == list(range(n))
    np.testing.assert_array_equal(a, native.shuffled_indices(n, seed=seed))
    np.testing.assert_array_equal(a, jnative.shuffled_indices(n, seed=seed))
    if n > 1:
        assert not np.array_equal(a, native.shuffled_indices(n, seed=seed + 1))


@pytest.mark.parametrize("native_shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batch_order_equals_the_jax_loaders(built, monkeypatch, native_shuffle,
                                                   drop_last):
    """Over three epochs, with and without the switch, the port's batches
    are the JAX loader's (rows, order, the padded tail and its mask); the
    switch changes the order."""
    from mlcomp_tpu.data.loader import DataLoader as JLoader
    from mlcomp_tpu_torch.data.loader import DataLoader

    if native_shuffle:
        monkeypatch.setenv("MLCOMP_TPU_NATIVE_SHUFFLE", "1")
    else:
        monkeypatch.delenv("MLCOMP_TPU_NATIVE_SHUFFLE", raising=False)
    rs = np.random.RandomState(4)
    data = {"x": rs.rand(45, 5).astype(np.float32), "y": np.arange(45, dtype=np.int32)}
    port = DataLoader(data, batch_size=16, shuffle=True, seed=3, drop_last=drop_last,
                      device="cpu")
    ref = JLoader(data, batch_size=16, shuffle=True, seed=3, drop_last=drop_last, mesh=None)
    orders = []
    for _ in range(3):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        orders.append(np.concatenate([b["y"].numpy() for b in got]).tolist())
    assert orders[0] != orders[1]
    rs_order = np.arange(45)
    np.random.RandomState(3).shuffle(rs_order)
    assert (orders[0][:32] == rs_order[:32].tolist()) == (not native_shuffle)


def _random_dag_case(rng, n, schema):
    """A random DAG (edges only point backward) and random statuses."""
    tasks = []
    for i in range(n):
        k = rng.integers(0, min(i, 3) + 1)
        deps = rng.choice(i, size=k, replace=False) if i and k else []
        tasks.append(schema.TaskSpec(
            name=f"t{i}", executor="noop", depends=tuple(f"t{int(d)}" for d in deps),
            resources=schema.ResourceSpec(priority=int(rng.integers(0, 5)))))
    st = schema.TaskStatus
    pool = [st.NOT_RAN, st.QUEUED, st.IN_PROGRESS, st.SUCCESS, st.FAILED, st.SKIPPED,
            st.STOPPED]
    return tasks, {t.name: pool[int(rng.integers(0, len(pool)))] for t in tasks}


def test_dag_analyze_equals_the_jax_native_and_the_python_walk(built, monkeypatch):
    """On 40 random DAGs: the port's analyzer (native) gives the JAX
    analyzer's (native) ready list, in order, and doomed set; both equal
    the port's Python walk (the fallback, with the library off)."""
    from mlcomp_tpu.dag import graph as jgraph
    from mlcomp_tpu.dag import schema as jschema
    from mlcomp_tpu_torch.dag import graph, schema

    def port_case(tasks, statuses):
        ptasks = [schema.TaskSpec(name=t.name, executor=t.executor, depends=t.depends,
                                  resources=schema.ResourceSpec(
                                      priority=t.resources.priority)) for t in tasks]
        return ptasks, {k: schema.TaskStatus(v.value) for k, v in statuses.items()}

    rng = np.random.default_rng(0)
    cases = [_random_dag_case(rng, int(rng.integers(1, 40)), jschema) for _ in range(40)]
    results = []
    for tasks, statuses in cases:
        ready, doomed = graph.DagAnalyzer(port_case(tasks, statuses)[0]).analyze(
            port_case(tasks, statuses)[1])
        jready, jdoomed = jgraph.DagAnalyzer(tasks).analyze(statuses)
        assert [t.name for t in ready] == [t.name for t in jready]
        assert doomed == jdoomed
        prios = [t.resources.priority for t in ready]
        assert prios == sorted(prios, reverse=True)
        results.append(([t.name for t in ready], doomed))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)        # as if the build had failed
    assert native.lib() is None and native.dag_analyze([0], [], [], []) is None
    for (tasks, statuses), (ready, doomed) in zip(cases, results):
        ptasks, pst = port_case(tasks, statuses)
        r2, d2 = graph.DagAnalyzer(ptasks).analyze(pst)
        assert ([t.name for t in r2], d2) == (ready, doomed)


def test_dag_analyze_native_actually_engaged(built):
    """The native path, not the fallback, runs where the library built (as
    tests/test_native.py holds for the JAX package)."""
    assert hasattr(built, "mlc_dag_analyze")
    args = (np.array([0, 0, 1]), np.array([0]), np.array([2, 0], dtype=np.int8),
            np.array([0, 0]))
    res = native.dag_analyze(*args)
    assert res is not None
    assert [r.tolist() for r in res] == [r.tolist() for r in jnative.dag_analyze(*args)] == [
        [1], []]


def test_a_cycle_falls_back_to_the_python_walk(built):
    """The native pass refuses a cyclic graph (None), as the reference's
    does; the analyzer then walks in Python."""
    from mlcomp_tpu_torch.dag import graph, schema

    res = native.dag_analyze(np.array([0, 1, 2]), np.array([1, 0]),
                             np.zeros(2, np.int8), np.zeros(2, np.int64))
    jres = jnative.dag_analyze(np.array([0, 1, 2]), np.array([1, 0]),
                               np.zeros(2, np.int8), np.zeros(2, np.int64))
    assert res is None and jres is None
    tasks = [schema.TaskSpec(name="a", executor="noop", depends=("b",)),
             schema.TaskSpec(name="b", executor="noop", depends=("a",))]
    ready, doomed = graph.DagAnalyzer(tasks).analyze({})
    assert ready == [] and doomed == set()
