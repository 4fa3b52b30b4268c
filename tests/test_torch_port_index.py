"""The port's index build against the JAX package's, on the CPU.

- ``kmeans`` with JAX's initial rows injected (``init``): the centroids
  within 1e-5 relative on separated clusters and on random data, and a
  cluster no row chooses keeps its centroid in both; two runs repeat bit
  for bit;
- ``knn_search_tiled``: the indices JAX's gives, distances within 1e-4;
  the CPU search streams above the threshold;
- ``write_index_ivf_flat``: the bytes JAX's writes; ``is_faiss_file`` and
  ``default_nlist``;
- ``build_index`` under ``Faiss`` and ``Auto`` (below the threshold): the
  vectors and the exported faiss file of JAX's, exactly; under ``KMeans``
  two builds write the same files; the ``index`` subcommand; a build asked
  for on a card that is absent raises.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _jax_init(n, k, seed):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                        replace=False))


def _rel(ref, out):
    return float(np.abs(ref - out).max() / np.abs(ref).max())


def _separated(rng, n_per=60, k=6, d=24):
    centers = 10.0 * rng.normal(size=(k, d))
    x = centers[:, None, :] + rng.normal(size=(k, n_per, d))
    return x.reshape(-1, d).astype(np.float32)


@pytest.mark.parametrize("kind", ["separated", "random"])
def test_kmeans_matches_jax_with_its_init(kind):
    from rvc_tpu.ops.retrieval import kmeans as jax_kmeans
    from rvc_tpu_torch.ops.retrieval import kmeans

    rng = np.random.default_rng(5)
    x = _separated(rng) if kind == "separated" else rng.normal(
        size=(400, 16)).astype(np.float32)
    k, seed = 12, 7
    ref = np.asarray(jax_kmeans(jax.random.PRNGKey(seed), jnp.asarray(x), k,
                                n_iters=10))
    out = kmeans(torch.from_numpy(x), k, n_iters=10,
                 init=_jax_init(len(x), k, seed)).numpy()
    assert out.shape == (k, x.shape[1]) and out.dtype == np.float32
    assert _rel(ref, out) <= 1e-5
    again = kmeans(torch.from_numpy(x), k, n_iters=10,
                   init=_jax_init(len(x), k, seed)).numpy()
    np.testing.assert_array_equal(again, out)


def test_kmeans_empty_cluster_keeps_its_centroid():
    """Two initial rows that are the same point: in the first iteration
    every row of theirs goes to the lower index, and the other centroid
    stays where it started; later iterations agree as well."""
    from rvc_tpu.ops.retrieval import kmeans as jax_kmeans
    from rvc_tpu_torch.ops.retrieval import kmeans

    rng = np.random.default_rng(6)
    x = rng.normal(size=(120, 8)).astype(np.float32)
    x[17] = x[3]
    k = 5
    init = np.array([3, 17, 40, 60, 90])
    for iters in (1, 6):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "choice", lambda *a, **kw: jnp.asarray(init))
            ref = np.asarray(jax_kmeans(jax.random.PRNGKey(0), jnp.asarray(x), k,
                                        n_iters=iters))
        out = kmeans(torch.from_numpy(x), k, n_iters=iters, init=init).numpy()
        if iters == 1:
            np.testing.assert_array_equal(out[1], x[17])
            np.testing.assert_array_equal(ref[1], x[17])
        assert _rel(ref, out) <= 1e-5


def test_kmeans_default_init_is_numpy_seeded():
    from rvc_tpu_torch.ops.retrieval import kmeans

    x = np.random.default_rng(8).normal(size=(50, 4)).astype(np.float32)
    out = kmeans(torch.from_numpy(x), 5, n_iters=0, seed=11).numpy()
    idx = np.random.default_rng(11).choice(50, 5, replace=False)
    np.testing.assert_array_equal(out, x[idx])
    with pytest.raises(ValueError, match="n_clusters"):
        kmeans(torch.from_numpy(x), 51)


def test_knn_search_tiled_matches_jax():
    from rvc_tpu.ops.retrieval import knn_search_tiled as jax_tiled
    from rvc_tpu_torch.ops import retrieval as rt

    rng = np.random.default_rng(9)
    q = rng.normal(size=(37, 32)).astype(np.float32)
    v = rng.normal(size=(1000, 32)).astype(np.float32)
    ref_d, ref_i = jax_tiled(jnp.asarray(q), jnp.asarray(v), 8, tile=256)
    d, i = rt.knn_search_tiled(torch.from_numpy(q), torch.from_numpy(v), 8, tile=256)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=0, atol=1e-4)
    # the CPU search streams an index above the threshold, with the same answer
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rt, "TILED_SEARCH_THRESHOLD", 500)
        calls = []
        mp.setattr(rt, "knn_search_tiled",
                   lambda *a, **kw: calls.append(kw) or rt.knn_search_plain(*a[:3]))
        rt.knn_topk(torch.from_numpy(q), torch.from_numpy(v), 8)
        assert calls == [{"tile": 65536}]


def test_ivf_flat_writer_bytes_equal_jax(tmp_path):
    from rvc_tpu.utils import faiss_io as jf
    from rvc_tpu_torch.utils import faiss_io

    v = np.random.default_rng(10).normal(size=(700, 16)).astype(np.float32)
    for nlist in (None, 3):
        a, b = str(tmp_path / "a.index"), str(tmp_path / "b.index")
        n1 = jf.write_index_ivf_flat(a, v, nlist=nlist, seed=4)
        n2 = faiss_io.write_index_ivf_flat(b, v, nlist=nlist, seed=4)
        assert n1 == n2
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()
        assert faiss_io.is_faiss_file(b) and not faiss_io.is_faiss_file(
            str(tmp_path / "missing"))
        np.testing.assert_array_equal(faiss_io.read_index_vectors(b), v)
    for n in (1, 38, 39, 500, 28500, 360000):
        assert faiss_io.default_nlist(n) == jf.default_nlist(n)


def _write_features(exp, seed=12, files=5):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(exp, "extracted"), exist_ok=True)
    for i in range(files):
        np.save(os.path.join(exp, "extracted", f"0_{i}_0.npy"),
                rng.normal(size=(int(rng.integers(40, 90)), 16)).astype(np.float32))


def _faiss_name(exp):
    return [f for f in os.listdir(exp) if f.endswith("_v2.index")]


@pytest.mark.parametrize("algorithm", ["Faiss", "Auto"])
def test_build_index_equals_jax(tmp_path, algorithm):
    from rvc_tpu.train.index_builder import build_index as jax_build
    from rvc_tpu_torch.train.index_builder import build_index

    outs = {}
    for pkg, fn, kw in (("jax", jax_build, {}), ("port", build_index, {"device": "cpu"})):
        exp = str(tmp_path / pkg / "model")
        _write_features(exp)
        path = fn(exp, algorithm=algorithm, export_faiss=True, **kw)
        assert path == os.path.join(exp, "model.index.npz")
        with np.load(path) as z:
            vec = z["vectors"]
        (faiss_file,) = _faiss_name(exp)
        with open(os.path.join(exp, faiss_file), "rb") as f:
            outs[pkg] = (vec, faiss_file, f.read())
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    assert outs["port"][1:] == outs["jax"][1:]


def test_build_index_kmeans_repeats(tmp_path, monkeypatch):
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.ops.retrieval import FeatureIndex
    from rvc_tpu_torch.train import index_builder

    # 24 centroids in place of 10 000, for the command line too
    monkeypatch.setattr(index_builder.build_index, "__defaults__", tuple(
        24 if d == 10_000 else d for d in index_builder.build_index.__defaults__))
    monkeypatch.chdir(tmp_path)
    exp = str(tmp_path / "logs" / "m")
    _write_features(exp)
    first = index_builder.build_index(exp, algorithm="KMeans", device="cpu")
    with open(first, "rb") as f:
        first_bytes = f.read()
    assert cli.main(["index", "--model_name", "m", "--index_algorithm", "KMeans",
                     "--export_faiss", "--device", "cpu"]) == 0
    with open(first, "rb") as f:
        assert f.read() == first_bytes
    index = FeatureIndex.load(first, device="cpu")
    assert index.ntotal == 24
    (faiss_file,) = _faiss_name(exp)
    from rvc_tpu_torch.utils.faiss_io import read_index_vectors

    np.testing.assert_array_equal(read_index_vectors(os.path.join(exp, faiss_file)),
                                  index.vectors.numpy())


def test_build_index_on_an_absent_card_raises(tmp_path):
    from rvc_tpu_torch.train.index_builder import build_index

    if torch.cuda.is_available():
        pytest.skip("a card is present: the build would run on it")
    exp = str(tmp_path / "m")
    _write_features(exp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_index(exp, algorithm="KMeans")
