"""The port's clustering, deep-clustering, DANet and ADANet against the JAX package's (CPU).

Tiny configs (F = 33 bins, H = 8 a direction, D = 4 or 6), inputs from numpy with a seed,
JAX weights carried across by `hub/from_jax.py` (the LSTMs' biases scrambled away from
zero), JAX's LSTM on `lax.scan` (`DNNTPU_PALLAS_LSTM=0`) under `jax.jit`, each value held
at TOL x max|ref| in f32 unless stated:
- KMeans (kmeans++ and random), SoftKMeans, SphericalKMeans and GMMClustering given JAX's
  initial centroids (the port draws its own from a torch.Generator, not jax.random's);
  the drawn inits are distinct samples and repeat with the seed;
- AffinityLoss (and its gradient) and PIT2d;
- DeepEmbedding, ChimeraNet, DeepEmbeddingPlus and FixedAttractorDANet forwards;
- DANet with the oracle assignment, with the threshold weight and with KMeans (JAX's
  init), and the gradients of a PIT2d step; ADANet forward and step gradients at dropout
  0 (combinations and permutations of anchors); ADANet's dropout keep share;
- `rmsprop` against `optax.rmsprop` over 5 clipped steps with one LR halving, at 1e-6;
- `IdealMaskSpectrogramTrainDataset` items (ibm, irm, wfm) against JAX's, bit for bit;
- DANet and ADANet port checkpoints opened in JAX's hub (`build_from_torch_checkpoint`),
  giving JAX's output;
- `cli/train_wsj0mix_spec.py` (danet with rmsprop, adanet with dropout, deep-clustering)
  and `cli/test_wsj0mix.py --spec_kind` per utterance against JAX's CLI on the same
  weights, the port's KMeans handed JAX's initial centroids through `KMeans._init`;
- the port's four recipe shells parsed to the JAX recipes' arguments, and `bench --model
  wavesplit|danet|adanet|deep-clustering` (its line, its FLOPs against
  `torch.utils.flop_counter`).
"""
import importlib
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dnn_based_source_separation_torch import bench
from dnn_based_source_separation_torch.algorithm import clustering as tcl
from dnn_based_source_separation_torch.cli import test_wsj0mix as ttest
from dnn_based_source_separation_torch.cli import train_wsj0mix_spec as ttrain
from dnn_based_source_separation_torch.criterion import AffinityLoss, L2Loss, PIT2d
from dnn_based_source_separation_torch.data import wsj0mix as twsj
from dnn_based_source_separation_torch.hub import (
    adanet_state_dict_from_jax, danet_state_dict_from_jax, deep_embedding_state_dict_from_jax,
)
from dnn_based_source_separation_torch.models import (
    ADANet, ChimeraNet, DANet, DeepEmbedding, DeepEmbeddingPlus, FixedAttractorDANet,
)
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_torch.ops import rnn as trnn
from dnn_based_source_separation_torch.ops.rnn import set_dropout_generator
from dnn_based_source_separation_torch.train import get_learning_rate, make_optimizer
from dnn_based_source_separation_torch.train import set_learning_rate
from dnn_based_source_separation_torch.train.attractor import (
    AnchoredAttractorTrainer, AttractorTrainer, EmbeddingTrainer,
)
from dnn_based_source_separation_tpu import models as jm
from dnn_based_source_separation_tpu.algorithm import clustering as jcl
from dnn_based_source_separation_tpu.cli import test_wsj0mix as jtest
from dnn_based_source_separation_tpu.criterion import AffinityLoss as JAffinityLoss
from dnn_based_source_separation_tpu.criterion import L2Loss as JL2Loss
from dnn_based_source_separation_tpu.criterion import PIT2d as JPIT2d
from dnn_based_source_separation_tpu.data import wsj0mix as jwsj
from dnn_based_source_separation_tpu.data.audio_io import write_wav
from dnn_based_source_separation_tpu.hub.torch_convert import build_from_torch_checkpoint
from dnn_based_source_separation_tpu.models.base import save_model as jax_save_model
from dnn_based_source_separation_tpu.train.steps import set_learning_rate as jax_set_lr
from test_torch_bench import _recipe_argv

TOL = 1e-4
F_BINS, T_FRAMES = 33, 21
DANET = dict(n_bins=F_BINS, embed_dim=4, hidden_channels=8, num_blocks=2)
ADANET = dict(DANET, num_anchors=4, dropout=0.0)


@pytest.fixture(autouse=True)
def _jax_scan(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _jax_init(n_clusters, seed=0, init_centroids="kmeans++"):
    """JAX's initial centroids (its `_init` at PRNGKey(seed)) drawn on the port's data."""
    def init(data):
        km = jcl.KMeans(n_clusters, init_centroids=init_centroids, seed=seed)
        return torch.from_numpy(np.array(km._init(jax.random.PRNGKey(seed),
                                                  jnp.asarray(data.detach().numpy()))))
    return init


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    """Every port KMeans draws JAX's initial centroids (through `KMeans._init`)."""
    monkeypatch.setattr(tcl.KMeans, "_init", lambda self, data: _jax_init(
        self.n_clusters, self.seed, self.init_centroids)(data))


def _blobs(seed=0, B=2, n=60, D=3, K=3):
    rng = np.random.default_rng(seed)
    centres = 3.0 * rng.standard_normal((B, K, D))
    labels = rng.integers(0, K, (B, n))
    x = np.take_along_axis(centres, labels[..., None], 1) + rng.standard_normal((B, n, D))
    return x.astype(np.float32)


# -- clustering -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["kmeans++", "random", "soft", "spherical", "gmm"])
def test_clustering_matches_jax_given_the_same_init(name):
    data = _blobs(seed=len(name))
    init_kind = "random" if name == "random" else "kmeans++"
    if name in ("kmeans++", "random"):
        jalg, alg = jcl.KMeans(3, init_centroids=name), tcl.KMeans(3, init_centroids=name)
    elif name == "soft":
        jalg, alg = jcl.SoftKMeans(3, beta=0.5), tcl.SoftKMeans(3, beta=0.5)
    elif name == "spherical":
        jalg, alg = jcl.SphericalKMeans(3), tcl.SphericalKMeans(3)
    else:
        jalg, alg = jcl.GMMClustering(3, n_iterations=6), tcl.GMMClustering(3, n_iterations=6)
    first, second = jax.jit(lambda d: jalg(d))(jnp.asarray(data))
    x = torch.from_numpy(data)
    got_first, got_second = alg(x, init=_jax_init(3, init_centroids=init_kind))
    if name in ("kmeans++", "random", "spherical"):
        np.testing.assert_array_equal(got_first.numpy(), np.asarray(first))
    else:
        _close(got_first, first)
    _close(got_second, second)


def test_drawn_inits_are_distinct_samples_and_repeat_with_the_seed():
    x = torch.from_numpy(_blobs(seed=3))
    for kind in ("kmeans++", "random"):
        km = tcl.KMeans(3, init_centroids=kind, seed=4)
        init = km._init(x)
        assert torch.equal(init, km._init(x))
        for b in range(x.shape[0]):
            rows = [int(torch.nonzero((x[b] == c).all(dim=-1))[0]) for c in init[b]]
            assert len(set(rows)) == 3
        assert not torch.equal(init, tcl.KMeans(3, init_centroids=kind, seed=5)._init(x))


# -- criteria ---------------------------------------------------------------------

def test_affinity_loss_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    V = rng.standard_normal((3, 50, 4)).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 50))]
    w = (rng.random((3, 50)) > 0.3).astype(np.float32)
    for mask in (None, w):
        loss, grad = jax.jit(jax.value_and_grad(lambda v: JAffinityLoss()(
            v, Y, binary_mask=mask)))(V)
        v = torch.from_numpy(V).requires_grad_()
        got = AffinityLoss()(v, torch.from_numpy(Y),
                             binary_mask=None if mask is None else torch.from_numpy(mask))
        got.backward()
        _close(got, loss)
        _close(v.grad, grad)
    per_item = AffinityLoss()(torch.from_numpy(V), torch.from_numpy(Y), batch_mean=False)
    _close(per_item, JAffinityLoss()(V, Y, batch_mean=False))


def test_pit2d_matches_jax():
    rng = np.random.default_rng(1)
    est = rng.random((4, 3, F_BINS, 7)).astype(np.float32)
    src = rng.random((4, 3, F_BINS, 7)).astype(np.float32)
    loss, pattern = JPIT2d(JL2Loss(), n_sources=3)(jnp.asarray(est), jnp.asarray(src),
                                                   batch_mean=False)
    got, got_pattern = PIT2d(L2Loss(), n_sources=3)(torch.from_numpy(est), torch.from_numpy(src),
                                                   batch_mean=False)
    _close(got, loss)
    np.testing.assert_array_equal(got_pattern.numpy(), np.asarray(pattern))


# -- models -----------------------------------------------------------------------

def _scrambled(variables, seed):
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, variables)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0]:
        parent = tree["params"]
        for p in path[:-1]:
            parent = parent[p.key]
        if path[-1].key.startswith("b_") or path[-1].key == "bias":
            parent[path[-1].key] = (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return tree


def _amplitude(seed=0, B=2, n_src=2):
    rng = np.random.default_rng(seed)
    src = rng.random((B, n_src, F_BINS, T_FRAMES)).astype(np.float32) ** 2
    mix = src.sum(axis=1, keepdims=True)
    assign = np.moveaxis(np.eye(n_src, dtype=np.float32)[src.argmax(axis=1)], -1, 1)
    weight = (mix > np.median(mix)).astype(np.float32)
    return mix, src, assign, weight


def _pair(jcls, tcls, config, convert, *init_args, seed=1):
    jmodel = jcls(**config)
    variables = _scrambled(jmodel.init(jax.random.PRNGKey(seed), *init_args), seed)
    port = tcls(**config).eval()
    port.load_state_dict(convert(variables, config))
    return jmodel, variables, port


@pytest.mark.parametrize("name", ["deep-embedding", "chimera", "deep-embedding-plus"])
def test_embedding_models_match_jax(name):
    classes = {"deep-embedding": (jm.DeepEmbedding, DeepEmbedding),
               "chimera": (jm.ChimeraNet, ChimeraNet),
               "deep-embedding-plus": (jm.DeepEmbeddingPlus, DeepEmbeddingPlus)}
    config = dict(n_bins=F_BINS, hidden_channels=8, embed_dim=6, num_layers=2)
    mix = _amplitude(seed=2)[0]
    jmodel, variables, port = _pair(*classes[name], config, deep_embedding_state_dict_from_jax,
                                    jnp.asarray(mix))
    expected = jax.jit(jmodel.apply)(variables, mix)
    got = port(torch.from_numpy(mix))
    if name == "chimera":
        _close(got[0], expected[0])
        _close(got[1], expected[1])
    else:
        _close(got, expected)


def test_fixed_attractor_danet_matches_jax():
    config = dict(DANET, n_sources=2)
    mix = _amplitude(seed=3)[0]
    jmodel, variables, port = _pair(jm.FixedAttractorDANet, FixedAttractorDANet, config,
                                    danet_state_dict_from_jax, jnp.asarray(mix))
    _close(port(torch.from_numpy(mix)), jax.jit(jmodel.apply)(variables, mix))


def _danet():
    mix, src, assign, weight = _amplitude(seed=4)
    return (*_pair(jm.DANet, DANet, DANET, danet_state_dict_from_jax, jnp.asarray(mix),
                   jnp.asarray(assign), jnp.asarray(weight)), mix, src, assign, weight)


def test_danet_oracle_threshold_and_kmeans_paths_match_jax(jax_kmeans_init):
    jmodel, variables, port, mix, src, assign, weight = _danet()
    t = [torch.from_numpy(a) for a in (mix, assign, weight)]
    for tw in (None, weight):
        out, latent, attractor = jax.jit(lambda v, m, a, w: jmodel.apply(
            v, m, a, w, method="extract_latent"))(variables, mix, assign, tw)
        got = port.extract_latent(t[0], t[1], None if tw is None else t[2])
        for g, e in zip(got, (out, latent, attractor)):
            _close(g, e)
    expected = jax.jit(lambda v, m: jmodel.apply(v, m, None, None, 2))(variables, mix)
    with torch.no_grad():
        _close(port(t[0], None, None, 2), expected)
    with pytest.raises(ValueError, match="n_sources"):
        port(t[0])


def test_danet_step_gradients_match_jax():
    jmodel, variables, port, mix, src, assign, weight = _danet()
    criterion, jcriterion = PIT2d(L2Loss(), n_sources=2), JPIT2d(JL2Loss(), n_sources=2)

    def loss_fn(p):  # JAX train/steps.py:make_attractor_train_step's loss
        return jcriterion(jmodel.apply({"params": p}, mix, assign, weight), jnp.asarray(src))[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    got = criterion(port(*(torch.from_numpy(a) for a in (mix, assign, weight))),
                    torch.from_numpy(src))[0]
    got.backward()
    _close(got, loss)
    ref = danet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads), DANET)
    for name, p in port.named_parameters():
        if p.requires_grad:
            _close(p.grad, ref[name])


@pytest.mark.parametrize("permute", [False, True])
def test_adanet_forward_and_step_gradients_match_jax(permute):
    # combinations without the threshold weight, permutations with it
    config = dict(ADANET, permute_anchors=permute)
    mix, src, _, weight = _amplitude(seed=5)
    jmodel, variables, port = _pair(jm.ADANet, ADANet, config, adanet_state_dict_from_jax,
                                    jnp.asarray(mix), jnp.asarray(weight), 2)
    tw = weight if permute else None
    expected = jax.jit(lambda v, m, w: jmodel.apply(v, m, w, 2, method="extract_latent"))(
        variables, mix, tw)
    got = port.extract_latent(torch.from_numpy(mix), None if tw is None else torch.from_numpy(tw),
                              2)
    for g, e in zip(got, expected):
        _close(g, e)
    jcriterion = JPIT2d(JL2Loss(), n_sources=2)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jcriterion(
        jmodel.apply({"params": p}, mix, weight, 2), jnp.asarray(src))[0]))(variables["params"])
    got = PIT2d(L2Loss(), n_sources=2)(port(torch.from_numpy(mix), torch.from_numpy(weight), 2),
                                       torch.from_numpy(src))[0]
    got.backward()
    _close(got, loss)
    ref = adanet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads), config)
    for name, p in port.named_parameters():
        if p.requires_grad:
            _close(p.grad, ref[name])


def test_adanet_dropout_keeps_a_share_of_keep(monkeypatch):
    rate, seen = 0.5, []
    plain = trnn.dropout

    def recording(x, *args):
        y = plain(x, *args)
        seen.append((x.detach(), y.detach()))
        return y

    monkeypatch.setattr(trnn, "dropout", recording)
    model = ADANet(**dict(ADANET, hidden_channels=16, dropout=rate),
                   generator=torch.Generator().manual_seed(0)).train()
    set_dropout_generator(model, torch.Generator().manual_seed(1))
    mix = _amplitude(seed=6, B=4)[0]
    model(torch.from_numpy(mix), None, 2)
    assert len(seen) == 1  # between the two layers only
    x, y = seen[0]
    kept = y != 0
    n, keep = y.numel(), 1 - rate
    assert abs(float(kept.float().mean()) - keep) <= 3 * (keep * rate / n) ** 0.5
    torch.testing.assert_close(y[kept], x[kept] / keep, rtol=0, atol=0)


# -- optimizer --------------------------------------------------------------------

def test_rmsprop_matches_optax_with_an_lr_halving():
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[scale * rng.standard_normal(s).astype(np.float32) / 3 for s in shapes]
             for scale in (1.0, 6.0, 1.5, 0.2, 3.0)]
    opt = optax.chain(optax.clip_by_global_norm(5.0),
                      optax.inject_hyperparams(optax.rmsprop)(learning_rate=1e-2))
    j_params = [jnp.asarray(a) for a in init]
    state = opt.init(j_params)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    port = make_optimizer("rmsprop", 1e-2, 5.0, params=params)
    for step, g in enumerate(grads):
        if step == 2:  # the Trainer's halving
            state = jax_set_lr(state, 5e-3)
            set_learning_rate(port, 5e-3)
            assert get_learning_rate(port) == 5e-3
        updates, state = opt.update([jnp.asarray(a) for a in g], state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        port.zero_grad()
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        port.step()
        for p, j in zip(params, j_params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=0, atol=1e-6)
    # ... and is not torch.optim.RMSprop (eps outside the square root, alpha 0.99)
    p = torch.nn.Parameter(torch.zeros(1))
    p.grad = torch.full((1,), 1e-4)
    make_optimizer("rmsprop", 1.0, params=[p]).step()
    q = torch.nn.Parameter(torch.zeros(1))
    q.grad = torch.full((1,), 1e-4)
    torch.optim.RMSprop([q], lr=1.0, eps=1e-8).step()
    assert abs(float(p.detach()) - float(q.detach())) > 0.1


# -- data, checkpoints and the CLIs -----------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tr: 3 mixtures of 1600 samples; cv: 2; tt: one of a length off the hop grid."""
    root = tmp_path_factory.mktemp("wsj0spec")
    rng = np.random.default_rng(0)
    for split, lengths in (("tr", (1600,) * 3), ("cv", (1600,) * 2), ("tt", (1213,))):
        for sub in ("mix", "s1", "s2"):
            os.makedirs(root / split / sub)
        utts = []
        for i, T in enumerate(lengths):
            t = np.arange(T) / 8000
            s1 = 0.3 * np.sin(2 * np.pi * (300 + 90 * i) * t) + 0.01 * rng.standard_normal(T)
            s2 = 0.2 * rng.standard_normal(T)
            utt = f"{split}{i}"
            write_wav(str(root / split / "s1" / f"{utt}.wav"), s1, 8000)
            write_wav(str(root / split / "s2" / f"{utt}.wav"), s2, 8000)
            write_wav(str(root / split / "mix" / f"{utt}.wav"), s1 + s2, 8000)
            utts.append(utt)
            (root / f"{split}{i}.lst").write_text(utt + "\n")
        (root / f"{split}.lst").write_text("\n".join(utts))
    return root


@pytest.mark.parametrize("mask_type", ["ibm", "irm", "wfm"])
def test_ideal_mask_dataset_matches_jax(corpus, mask_type):
    kw = dict(n_fft=64, hop_length=16, mask_type=mask_type, threshold=30.0, samples=800)
    args = (str(corpus / "tr"), str(corpus / "tr.lst"))
    ds, jds = twsj.IdealMaskSpectrogramTrainDataset(*args, **kw), \
        jwsj.IdealMaskSpectrogramTrainDataset(*args, **kw)
    assert len(ds) == len(jds) == 9
    for i in (0, 4, 8):
        items, expected = ds[i], jds[i]
        assert items[0].shape == (1, F_BINS, 51) and items[2].shape == (2, F_BINS, 51)
        for a, b in zip(items, expected):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert 0 < items[3].mean() < 1


@pytest.mark.parametrize("name", ["danet", "adanet"])
def test_port_checkpoints_open_in_jax_and_give_its_output(tmp_path, name):
    mix, _, assign, weight = _amplitude(seed=7)
    cls, config = (DANet, DANET) if name == "danet" else (ADANet, ADANET)
    port = cls(**config, generator=torch.Generator().manual_seed(2)).eval()
    path = str(tmp_path / f"{name}.pth")
    save_model(path, port)
    jmodel, params = build_from_torch_checkpoint(path)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    assert type(jmodel).__name__ == cls.__name__
    if name == "danet":  # the oracle path: no clustering draws
        expected = jax.jit(jmodel.apply)(params, mix, assign, weight)
        got = port(*(torch.from_numpy(a) for a in (mix, assign, weight)))
    else:
        expected = jax.jit(lambda p, m, w: jmodel.apply(p, m, w, 2))(params, mix, weight)
        got = port(torch.from_numpy(mix), torch.from_numpy(weight), 2)
    _close(got, expected)
    reloaded = load_model(path)
    assert type(reloaded) is cls
    torch.testing.assert_close(reloaded.state_dict(), port.state_dict())


SPEC_CLI = {
    "danet": ["--model", "danet", "--optimizer", "rmsprop", "--lr", "1e-3"],
    "adanet": ["--model", "adanet", "-N", "3", "--dropout", "0.5", "--optimizer", "adam"],
    "deep-clustering": ["--model", "deep-clustering", "--criterion", "affinity",
                        "--optimizer", "momentum-sgd", "--lr", "1e-3"],
}


def _spec_args(corpus, exp, *extra):
    return ["--train_wav_root", str(corpus / "tr"), "--train_list_path", str(corpus / "tr.lst"),
            "--valid_wav_root", str(corpus / "cv"), "--valid_list_path", str(corpus / "cv.lst"),
            "--duration", "0.1", "--n_fft", "64", "--hop_length", "16", "-K", "4", "-H", "8",
            "-B", "2", "--batch_size", "4", "--exp_dir", str(exp), "--device", "cpu", *extra]


@pytest.mark.parametrize("model", list(SPEC_CLI))
def test_spec_cli_trains_and_resumes(corpus, tmp_path, model, monkeypatch):
    exp = tmp_path / "exp"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    trainer = ttrain.main(_spec_args(corpus, exp, "--epochs", "2", *SPEC_CLI[model]))
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    kind = {"danet": AttractorTrainer, "adanet": AnchoredAttractorTrainer,
            "deep-clustering": EmbeddingTrainer}[model]
    assert type(trainer) is kind
    assert len(trainer.train_loss) == 2 and all(np.isfinite(trainer.train_loss
                                                             + trainer.valid_loss))
    last = exp / "model" / "last.ckpt"
    resumed = ttrain.main(_spec_args(corpus, exp, "--epochs", "3", "--continue_from", str(last),
                                     *SPEC_CLI[model]))
    assert resumed.start_epoch == 2 and resumed.train_loss[:2] == trainer.train_loss
    if model == "danet":  # rmsprop's state went into the checkpoint and came back
        state = resumed.optimizer.state_dict()["state"]
        assert state and all("nu" in s for s in state.values())
    assert type(load_model(str(last))).__name__ == {
        "danet": "DANet", "adanet": "ADANet", "deep-clustering": "DeepEmbedding"}[model]


def test_spec_cli_refusals(corpus, tmp_path):
    with pytest.raises(ValueError, match="affinity"):
        ttrain.main(_spec_args(corpus, tmp_path, "--model", "deep-clustering"))
    with pytest.raises(NotImplementedError, match="n_devices"):
        ttrain.main(_spec_args(corpus, tmp_path, "--n_devices", "1"))
    if not torch.cuda.is_available():
        args = _spec_args(corpus, tmp_path)
        args[args.index("--device") + 1] = "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(args)


TOL_CLI = {"loss": 1e-3, "loss_improvement": 1e-3, "sdr_improvement": 1e-2,
           "sir_improvement": 1e-2, "sar": 1e-2}


def test_spec_kind_evaluation_matches_jax_per_utterance(corpus, tmp_path, jax_kmeans_init):
    # The same DANet weights as a JAX checkpoint and a port checkpoint; the port's KMeans
    # starts from JAX's initial centroids (the fixture), so both CLIs run one function.
    mix = jnp.zeros((1, 1, F_BINS, 5))
    jmodel = jm.DANet(**DANET)
    variables = _scrambled(jmodel.init(jax.random.PRNGKey(3), mix, jnp.zeros((1, 2, F_BINS, 5)),
                                       None), 3)
    jax_ckpt, port_ckpt = str(tmp_path / "danet.ckpt"), str(tmp_path / "danet.pth")
    jax_save_model(jax_ckpt, jmodel, variables, {})
    port = DANet(**DANET)
    port.load_state_dict(danet_state_dict_from_jax(variables, DANET))
    save_model(port_ckpt, port)
    for i in range(1):
        lst = str(corpus / f"tt{i}.lst")
        flags = ["--test_wav_root", str(corpus / "tt"), "--test_list_path", lst, "--spec_kind",
                 "danet", "--n_fft", "64", "--hop_length", "16"]
        expected = jtest.main([*flags, "--model_path", jax_ckpt])
        got = ttest.main([*flags, "--model_path", port_ckpt, "--device", "cpu"])
        for key, tol in TOL_CLI.items():
            assert np.isfinite(got[key]), (key, got)
            assert abs(got[key] - expected[key]) <= tol, (i, key, got[key], expected[key])


# -- recipes and the bench -------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent.parent
RECIPE_CLIS = {"wavesplit": "train_wsj0mix_wavesplit", "danet": "train_wsj0mix_spec",
               "adanet": "train_wsj0mix_spec", "deep-clustering": "train_wsj0mix_spec"}


@pytest.mark.parametrize("recipe", list(RECIPE_CLIS))
def test_recipe_shells_parse_as_jax_parses_them(recipe):
    """The port's recipe shells, each parsed by the port's CLI parser, give the JAX recipe's
    arguments (plus --device), and the spectrogram factory builds the JAX factory's model."""
    module, argv = _recipe_argv(ROOT / "dnn_based_source_separation_torch" / "egs" / "wsj0-mix"
                                / recipe / "train.sh")
    jmodule, jargv = _recipe_argv(ROOT / "egs" / "wsj0-mix" / recipe / "train.sh")
    cli = RECIPE_CLIS[recipe]
    assert (module, jmodule) == (f"dnn_based_source_separation_torch.cli.{cli}",
                                 f"dnn_based_source_separation_tpu.cli.{cli}")
    port_cli = importlib.import_module(module)
    args = port_cli.build_parser().parse_args(argv)
    jargs = importlib.import_module(jmodule).build_parser().parse_args(jargv)
    assert args.device == "device" and "--device" not in jargv
    for name, value in vars(jargs).items():
        assert getattr(args, name) == value, name
    if cli == "train_wsj0mix_spec":
        port = port_cli.build_spec_model(args, args.n_fft // 2 + 1, "cpu")
        jmodel = importlib.import_module(jmodule).build_spec_model(jargs, jargs.n_fft // 2 + 1)
        assert type(port).__name__ == type(jmodel).__name__
        for field, value in port.get_config().items():
            assert getattr(jmodel, field) == value, field


BENCH_TINY = {"wavesplit": dict(latent_dim=8, spk_num_layers=2, sep_num_blocks=1,
                                sep_num_layers=2),
              "danet": dict(hidden_channels=8), "adanet": dict(hidden_channels=8),
              "deep-clustering": dict(hidden_channels=8)}


@pytest.mark.parametrize("model", list(BENCH_TINY))
def test_bench_line_and_flops(monkeypatch, model):
    """`bench --model` at tiny widths: its JSON line, and its FLOP count against
    torch.utils.flop_counter over the same forward (which counts the products and
    convolutions, and of KMeans the centroid sums, not the distances)."""
    monkeypatch.setattr(bench, "SECONDS", 0.1)
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setitem(bench.CONFIGS, model, dict(bench.CONFIGS[model], **BENCH_TINY[model]))
    result = bench.main(["--device", "cpu", "--dtype", "float32", "--model", model])
    assert result["metric"] == f"{model.replace('-', '_')}_wsj0mix_inference_rtf"
    assert result["ms"] > 0 and result["mfu"] is None
    args = bench.build_parser().parse_args(["--device", "cpu", "--dtype", "float32",
                                            "--model", model])
    served = bench.build_model(args, torch.device("cpu"))
    T = int(bench.SECONDS * bench.SAMPLE_RATE)
    flops = bench.forward_flops(served, T, bench.BATCH)
    assert result["flops"] == sum(flops.values())
    iters = 10
    counted_clustering = flops["clustering"] * iters // (2 * iters + 1)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        served(torch.randn(bench.BATCH, 1, T))
    assert counter.get_total_flops() == flops["matmul"] + flops["depthwise"] + counted_clustering
