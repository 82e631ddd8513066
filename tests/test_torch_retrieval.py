"""Image retrieval of the PyTorch port against the JAX package, on the CPU:
NetVLAD and AP-GeM at narrow widths (tests/test_netvlad_weights.py's
scaled VGG16 widths, one bottleneck per ResNet layer) on the same weights
(the flax init carried over by weights.load_flax_retrieval), the ranking
and recall functions, both checkpoint loaders on the synthetic checkpoint
files tests/test_netvlad_weights.py and tests/test_gem_weights.py write,
and run_scene_retrieval's pkls on a written scene (JAX resizes with
cv2.INTER_AREA, the port with data/imgproc.resize_area).

Bounds: descriptors 1e-5 (they are unit vectors), rankings and pkls equal.
"""
import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfloc_tpu.retrieval as jretrieval
from nerfloc_tpu.data.scene_store import SceneStore as JSceneStore
from nerfloc_tpu.retrieval import pipeline as jpipe
from nerfloc_tpu.retrieval.gem import GeMDescriptor as JGeM
from nerfloc_tpu.retrieval.gem_weights import load_dirtorch as j_load_dirtorch
from nerfloc_tpu.retrieval.gem_weights import port_dirtorch_gem as j_port_dirtorch_gem
from nerfloc_tpu.retrieval.gem_weights import whiten_features as j_whiten
from nerfloc_tpu.retrieval.netvlad import NetVLAD as JNetVLAD
from nerfloc_tpu.retrieval.netvlad_weights import load_matconvnet_netvlad as j_load_mat
from nerfloc_tpu.retrieval.vis import save_retrieval_strips as j_strips
from nerfloc_tpu_torch.data import png
from nerfloc_tpu_torch.data.scene_store import SceneStore
from nerfloc_tpu_torch.data.synthetic import write_scene
from nerfloc_tpu_torch.retrieval import get_retrieval_model
from nerfloc_tpu_torch.retrieval import pipeline as tpipe
from nerfloc_tpu_torch.retrieval.gem import GeMDescriptor
from nerfloc_tpu_torch.retrieval.gem_weights import load_dirtorch, port_dirtorch_gem
from nerfloc_tpu_torch.retrieval.gem_weights import whiten_features
from nerfloc_tpu_torch.retrieval.netvlad import NetVLAD
from nerfloc_tpu_torch.retrieval.netvlad_weights import load_matconvnet_netvlad
from nerfloc_tpu_torch.retrieval.vis import save_retrieval_strips
from nerfloc_tpu_torch.weights import load_flax_retrieval

from _torch_parity import few_threads  # noqa: F401
from test_gem_weights import _fake_dirtorch_sd
from test_netvlad_weights import CFG, K, OUT, _make_mat

TOL = 1e-5
GEM_BLOCKS = (1, 1, 1, 1)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def images(seed, n=2, hw=32):
    return np.random.default_rng(seed).uniform(size=(n, hw, hw, 3)).astype(np.float32)


def netvlad_pair(**kw):
    """A narrow flax NetVLAD, its init, and the port's with its weights."""
    jm = JNetVLAD(num_clusters=K, out_dim=OUT, vgg_cfg=CFG, **kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tm = NetVLAD(num_clusters=K, out_dim=OUT, vgg_cfg=CFG, **kw)
    assert load_flax_retrieval(tm, jax.tree.map(np.asarray, v)) == []
    return jm, v, tm.eval()


def gem_pair():
    jm = JGeM(out_dim=OUT, blocks=GEM_BLOCKS, p_init=2.5)
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
    tm = GeMDescriptor(out_dim=OUT, blocks=GEM_BLOCKS, p_init=0.0)
    assert load_flax_retrieval(tm, jax.tree.map(np.asarray, v)) == []
    return jm, v, tm.eval()


@pytest.mark.parametrize("kw", [{}, {"input_scale": 255.0, "pixel_mean": (110., 115., 120.)},
                                {"whiten": False}],
                         ids=["default", "matconvnet-preprocessing", "no-whitening"])
def test_netvlad_matches_jax(kw):
    jm, v, tm = netvlad_pair(**kw)
    x = images(0)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    close(got, want)
    assert got.shape == (2, OUT if kw.get("whiten", True) else K * CFG[-1])


def test_gem_matches_jax():
    jm, v, tm = gem_pair()
    assert float(tm.p.detach()) == pytest.approx(2.5)
    x = images(1, hw=64)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    close(got, jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():                   # p outside [1, 10] is clipped
        tm.p.fill_(12.0)
        got = tm(torch.from_numpy(x))
    v12 = {**v, "params": {**v["params"], "p": jnp.float32(12.0)}}
    close(got, jax.jit(jm.apply)(v12, jnp.asarray(x)))


def test_full_width_models_build():
    """The registry's models at full width: VGG16 conv5_3 (512), 64
    clusters, whitening 32768 -> 4096; ResNet101 (3, 4, 23, 3), fc 2048."""
    nv = get_retrieval_model("netvlad")
    assert nv.whiten.weight.shape == (4096, 64 * 512) and nv.centers.shape == (64, 512)
    gem = get_retrieval_model("dir")
    assert gem.blocks == (3, 4, 23, 3) and gem.whiten.weight.shape == (2048, 2048)
    assert torch.equal(get_retrieval_model("netvlad").centers, nv.centers)
    with pytest.raises(KeyError, match="unknown retrieval method"):
        get_retrieval_model("sift")


# -- ranking and recall --------------------------------------------------------------

def _poses(rng, n):
    out = {}
    for i in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        T = np.eye(4)
        T[:3, :3] = q * np.sign(np.linalg.det(q))
        T[:3, 3] = rng.uniform(-1, 1, 3)
        out[f"f{i:03d}.png"] = T
    return out


@pytest.mark.parametrize("self_match,interval", [(False, 1), (True, 1), (False, 2)])
def test_rankings_and_recall_match_jax(self_match, interval):
    rng = np.random.default_rng(2)
    d = rng.standard_normal((12, 16)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    names = [f"f{i:03d}.png" for i in range(12)]
    kw = dict(allow_self_match=self_match, interval=interval)
    assert tpipe.retrieve_top_k(d[:5], names[:5], d, names, 4, **kw) == \
        jpipe.retrieve_top_k(d[:5], names[:5], d, names, 4, **kw)
    db, q = _poses(rng, 12), dict(list(_poses(rng, 12).items())[:5])
    assert tpipe.retrieve_top_k_oracle(q, db, 4, **kw) == \
        jpipe.retrieve_top_k_oracle(q, db, 4, **kw)
    np.testing.assert_array_equal(tpipe.pose_distance(q["f000.png"], np.stack(list(db.values()))),
                                  jpipe.pose_distance(q["f000.png"], np.stack(list(db.values()))))
    top = tpipe.retrieve_top_k_oracle(q, db, 4, **kw)
    for thr in ((30.0, 0.5), (90.0, 1.5)):
        assert tpipe.evaluate_retrieval(db, q, top, *thr, max_k=3) == \
            jpipe.evaluate_retrieval(db, q, top, *thr, max_k=3)


# -- checkpoint loaders ----------------------------------------------------------------

def test_matconvnet_loader_matches_jax(tmp_path):
    path, _, avg = _make_mat(tmp_path, np.random.default_rng(0))
    jm, jv = j_load_mat(path)
    tm = load_matconvnet_netvlad(path).eval()
    assert (tm.input_scale, tm.num_clusters, tm.out_dim) == (255.0, K, OUT)
    assert tm.vgg_cfg == jm.vgg_cfg
    np.testing.assert_allclose(tm.pixel_mean, avg)
    x = images(3)
    with torch.no_grad():
        close(tm(torch.from_numpy(x)), jm.apply(jv, jnp.asarray(x)))


def test_dirtorch_loaders_match_jax(tmp_path):
    sd = _fake_dirtorch_sd(np.random.default_rng(0))
    jm, jv = j_port_dirtorch_gem(sd)
    tm = port_dirtorch_gem(sd).eval()
    assert tm.blocks == jm.blocks and tm.out_dim == jm.out_dim
    x = images(4, hw=64)
    want = jm.apply(jv, jnp.asarray(x))
    with torch.no_grad():
        close(tm(torch.from_numpy(x)), want)
    path = str(tmp_path / "gem.pt")
    pca = SimpleNamespace(components_=np.eye(32, dtype=np.float32)[::-1].copy(),
                          mean_=np.full(32, 0.01, np.float32),
                          singular_values_=np.linspace(2.0, 0.5, 32).astype(np.float32))
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}, "pca": {"Landmarks_clean": pca}}, path)
    jm2, jv2, jpca = j_load_dirtorch(path)
    tm2, tpca = load_dirtorch(path)
    with torch.no_grad():
        d = tm2.eval()(torch.from_numpy(x)).numpy()
    close(d, jm2.apply(jv2, jnp.asarray(x)))
    assert sorted(tpca) == sorted(jpca) == ["Landmarks_clean"]
    for kw in ({}, {"whitenv": 8}, {"l2norm": False, "whitenp": 0.5, "whitenm": 2.0}):
        close(whiten_features(d, tpca["Landmarks_clean"], **kw),
              j_whiten(d, jpca["Landmarks_clean"], **kw))


# -- the pipeline on a written scene -------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A scene at 240x320 (retrieval resizes to 224x224), 6 train and 2
    test frames; the weights of the narrow models."""
    root = tmp_path_factory.mktemp("retrieval")
    write_scene(str(root), scene="box", n_train=6, n_test=2, n_support=4, H=240, W=320)
    return str(root)


@pytest.mark.parametrize("method", ["netvlad", "dir", "oracle"])
def test_run_scene_retrieval_pkls_equal_jax(scene, method, monkeypatch):
    """JAX's registry gives the narrow models; both packages write their
    pkls, which must be equal, as the recall."""
    jm, v, tm = {"netvlad": netvlad_pair, "dir": gem_pair,
                 "oracle": lambda: (None, None, None)}[method]()
    if jm is not None:
        monkeypatch.setitem(jretrieval._REGISTRY, method, lambda: jm)
    jstore = JSceneStore.load(scene, "box")
    want_m = jpipe.run_scene_retrieval(jstore, method, 3, netvlad_params=v)
    want = {s: pickle.load(open(os.path.join(scene, "box", f"image_retrieval_{s}_{method}.pkl"),
                                "rb")) for s in ("train", "test")}
    for s in want:
        os.remove(os.path.join(scene, "box", f"image_retrieval_{s}_{method}.pkl"))
    got_m = tpipe.run_scene_retrieval(SceneStore.load(scene, "box"), method, 3, model=tm,
                                      device="cpu")
    got = {s: pickle.load(open(os.path.join(scene, "box", f"image_retrieval_{s}_{method}.pkl"),
                               "rb")) for s in ("train", "test")}
    assert got == want
    assert got_m == want_m
    assert len(got["test"]) == 2 and len(got["train"]) == 6


def test_descriptors_batch_padding_and_cli(scene, tmp_path):
    """extract_descriptors pads its last batch (5 frames in batches of 2
    equal one batch of 8); the CLI writes the oracle pkls and asks for
    CUDA by default."""
    _, _, tm = netvlad_pair()
    store = SceneStore.load(scene, "box")
    frames = store.train_frames[:5]
    a = tpipe.extract_descriptors(frames, scene, model=tm, batch=2, device="cpu")
    b = tpipe.extract_descriptors(frames, scene, model=tm, batch=8, device="cpu")
    close(a, b, 1e-6)
    cfg = tmp_path / "c.yaml"
    data = tmp_path / "d.yaml"
    data.write_text(f"name: d\nbase_dir: {scene}\nscenes: [box]\n")
    cfg.write_text(f"dataset_type: {data}\nimage_core_set_size: 3\n")
    assert tpipe.main(["--config", str(cfg), "--method", "oracle", "--device", "cpu"]) == 0
    pkl = os.path.join(scene, "box", "image_retrieval_test_oracle.pkl")
    got = pickle.load(open(pkl, "rb"))
    jpipe.run_scene_retrieval(JSceneStore.load(scene, "box"), "oracle", 3)
    assert got == pickle.load(open(pkl, "rb"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.main(["--config", str(cfg), "--method", "oracle"])


def test_retrieval_strips_equal_jax(scene, tmp_path):
    store = SceneStore.load(scene, "box")
    top = {f["file_name"]: [g["file_name"] for g in store.train_frames[:3]]
           for f in store.test_frames}
    written = save_retrieval_strips(scene, top, str(tmp_path / "port"), thumb=64)
    j_strips(scene, top, str(tmp_path / "jax"), thumb=64)
    assert len(written) == 2
    import cv2
    for path in written:
        got = png.decode(open(path, "rb").read())
        want = cv2.cvtColor(cv2.imread(os.path.join(tmp_path / "jax", os.path.basename(path))),
                            cv2.COLOR_BGR2RGB)
        assert np.array_equal(got, want)
