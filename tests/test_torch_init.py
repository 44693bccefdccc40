"""The port's initialisers (``models/init.py``) against the JAX package's.

Each initialiser draws from the JAX function's key tree, so one key gives
the JAX package's initial weights. The port's parameters are turned into
the JAX layout (``io.convert``) and held leaf by leaf against the JAX
tree: uniform draws, zeros and ones bit for bit, ``scale * normal`` within
3 ulp (the port's normals against ``jax.random.normal``, as
``tests/test_torch_rng.py`` holds them), the pretrained projection's
product within float32 matmul rounding (1e-6). Then the CLIs: a fresh
``--train`` of the text and MNIST CLIs and ``train_lm`` build the JAX
CLIs' weights at the same ``--seed``. Last, ``ops.rng.draw_many`` on the
CPU and the text step's hoisted attention seeds and dropout key.
"""

import ctypes
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tinydiffusionmodels_tpu.models import (  # noqa: E402
    ar_lm as jax_ar_lm,
    classifier as jax_classifier,
    embedding as jax_embedding,
    transformer as jax_transformer,
    unet as jax_unet,
)
from tinydiffusionmodels_torch import ops  # noqa: E402
from tinydiffusionmodels_torch.core import rng  # noqa: E402
from tinydiffusionmodels_torch.io import convert  # noqa: E402
from tinydiffusionmodels_torch.models import (  # noqa: E402
    DigitClassifier,
    LearnedEmbedding,
    LearnedRounding,
    SimpleUNet,
    TinyGPT,
    TinyGPTConfig,
    TinyTransformer,
    TransformerConfig,
)

torch.set_num_threads(1)

SEEDS = (0, 1, 2)
DIM, DEPTH, VOCAB, MAX_LEN = 32, 2, 64, 16
NORMAL_ULPS = 3
# Leaves drawn as scale * normal: the text denoiser's position table, the
# embedding table, TinyGPT's token and position tables.
NORMALS = {"pos_emb", "weight", "tok_emb"}


def _ulps(a: np.ndarray, b: np.ndarray) -> float:
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    mag = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    step = np.nextafter(mag, np.float32(np.inf)).astype(np.float64) - mag
    return float(np.max(np.abs(a64 - b64) / step)) if a.size else 0.0


def _leaves(tree, prefix=()):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, np.asarray(tree)


def _assert_tree(port: dict, want: dict, *, product=()) -> None:
    """The port's JAX-layout tree against the JAX tree: the same leaves,
    shapes and dtypes; normals within NORMAL_ULPS, the leaves in
    ``product`` within 1e-6, the rest bit-equal."""
    got, ref = dict(_leaves(port)), dict(_leaves(want))
    assert got.keys() == ref.keys()
    for path, a in got.items():
        b = ref[path]
        assert a.shape == b.shape and b.dtype == np.float32, path
        if path[-1] in product:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                       err_msg=str(path))
        elif path[-1] in NORMALS:
            assert _ulps(a, b) <= NORMAL_ULPS, path
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(path))


def _cfgs(pos_emb: str, self_cond: bool):
    kw = dict(dim=DIM, n_heads=4, depth=DEPTH, ffn_dim=2 * DIM,
              pos_emb=pos_emb, self_cond=self_cond, max_len=MAX_LEN)
    return jax_transformer.TransformerConfig(**kw), TransformerConfig(**kw)


def _joint_tree(**modules) -> dict:
    return convert.params_tree(torch.nn.ModuleDict(modules))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pos_emb,self_cond", [("none", False),
                                               ("abs", True)])
def test_transformer_init_is_jax_init(seed, pos_emb, self_cond):
    jcfg, tcfg = _cfgs(pos_emb, self_cond)
    model = TinyTransformer(tcfg, key=rng.prng_key(seed))
    want = jax_transformer.init_tiny_transformer(jax.random.PRNGKey(seed),
                                                 jcfg)
    _assert_tree(_joint_tree(diffusion_model=model)["diffusion_model"], want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pre_dim", [None, DIM, 48])
def test_embedding_init_is_jax_init(seed, pre_dim):
    """The 0.02 N(0, 1) table, a pretrained matrix as it is, and one
    projected through the untrained Linear(pre_dim, dim)."""
    pre = None if pre_dim is None else np.random.default_rng(seed).normal(
        size=(VOCAB, pre_dim)).astype(np.float32)
    model = LearnedEmbedding(VOCAB, DIM, pretrained=pre,
                             key=rng.prng_key(seed))
    want = jax_embedding.init_learned_embedding(jax.random.PRNGKey(seed),
                                                VOCAB, DIM, pre)
    port = _joint_tree(embedding_fn=model)["embedding_fn"]
    if pre_dim is None:
        _assert_tree(port, want)
    else:
        _assert_tree(port, want, product=("weight",))


@pytest.mark.parametrize("seed", SEEDS)
def test_rounding_init_is_jax_init(seed):
    model = LearnedRounding(DIM, VOCAB, key=rng.prng_key(seed))
    want = jax_embedding.init_learned_rounding(jax.random.PRNGKey(seed), DIM,
                                               VOCAB)
    _assert_tree(_joint_tree(rounding_fn=model)["rounding_fn"], want)


@pytest.mark.parametrize("seed", SEEDS)
def test_unet_init_is_jax_init(seed):
    model = SimpleUNet(key=rng.prng_key(seed))
    want = jax_unet.init_unet(jax.random.PRNGKey(seed))
    _assert_tree(convert.unet_params_dict(model), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_tiny_gpt_init_is_jax_init(seed):
    kw = dict(vocab_size=VOCAB, dim=DIM, n_heads=4, depth=2,
              max_len=MAX_LEN)
    model = TinyGPT(TinyGPTConfig(**kw), key=rng.prng_key(seed))
    want = jax_ar_lm.init_tiny_gpt(jax.random.PRNGKey(seed),
                                   jax_ar_lm.TinyGPTConfig(**kw))
    _assert_tree(convert.tiny_gpt_params_dict(model), want)


def _classifier_tree(model: DigitClassifier) -> dict:
    """The inverse of ``convert.classifier_state_from_jax``."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def conv(name):
        return {"w": sd[f"{name}.weight"].transpose(2, 3, 1, 0),
                "b": sd[f"{name}.bias"]}

    w1 = sd["fc1.weight"].T                         # (1568, 128), CHW rows
    w1 = w1.reshape(32, 7, 7, -1).transpose(1, 2, 0, 3).reshape(w1.shape)
    return {"conv1": conv("conv1"), "conv2": conv("conv2"),
            "fc1": {"w": w1, "b": sd["fc1.bias"]},
            "fc2": {"w": sd["fc2.weight"].T, "b": sd["fc2.bias"]}}


@pytest.mark.parametrize("seed", SEEDS)
def test_classifier_init_is_jax_init(seed):
    model = DigitClassifier(key=rng.prng_key(seed))
    want = jax_classifier.init_classifier(jax.random.PRNGKey(seed))
    _assert_tree(_classifier_tree(model), want)


def test_a_device_key_path_draws_the_host_keys_weights():
    """A key held as a ``KeyPath`` (a base key and a counter, as a
    device's key is) gives the weights of the key it resolves to."""
    path = rng.substream(rng.KeyPath(rng.prng_key(3),
                                     torch.tensor([5])), "diffusion")
    _, tcfg = _cfgs("abs", False)
    a = TinyTransformer(tcfg, key=path)
    b = TinyTransformer(tcfg, key=path.resolve())
    for name, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[name]), name


def test_skip_init_draws_nothing(monkeypatch):
    """``nn.utils.skip_init`` (the loaders' way to build a module for a
    checkpoint) makes no draw."""
    monkeypatch.setattr(ops.rng, "draw_many", None)
    _, tcfg = _cfgs("abs", True)
    for cls, args in ((TinyTransformer, (tcfg,)), (SimpleUNet, ()),
                      (LearnedRounding, (DIM, VOCAB)),
                      (LearnedEmbedding, (VOCAB, DIM)),
                      (DigitClassifier, ()),
                      (TinyGPT, (TinyGPTConfig(vocab_size=VOCAB, dim=DIM,
                                               depth=1, max_len=4),))):
        module = torch.nn.utils.skip_init(cls, *args)
        assert next(module.parameters()).device.type == "cpu"


# --- a fresh --train of each CLI --------------------------------------------

CORPUS = "To be, or not to be, that is the question.\n" * 8


class _Captured(Exception):
    def __init__(self, value):
        super().__init__("captured")
        self.value = value


def _raise(value):
    raise _Captured(value)


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "tiny_shakespeare.txt").write_text(CORPUS)
    return tmp_path


def _capture(fn):
    with pytest.raises(_Captured) as info:
        fn()
    return info.value.value


@pytest.mark.parametrize("seed", [0, 7])
def test_text_cli_trains_from_the_jax_clis_weights(workdir, monkeypatch,
                                                   seed):
    """``shakespeare --train`` hands its trainer the JAX CLI's initial
    denoiser, rounding head and embedding table at the same ``--seed``
    (the substreams "diffusion", "rounding", "embedding")."""
    from tinydiffusionmodels_tpu import shakespeare as jax_cli
    from tinydiffusionmodels_tpu.train import text_train as jax_train
    from tinydiffusionmodels_torch import shakespeare as port_cli
    from tinydiffusionmodels_torch.train import text_train as port_train

    argv = ["--train", "--model_id", "char", "--data_root", "data",
            "--seq_len", "16", "--embed_dim", str(DIM), "--depth", "2",
            "--epochs", "1", "--batch_size", "4", "--pos_emb", "abs",
            "--self_cond", "--seed", str(seed), "--ckpt", "t.pth"]
    monkeypatch.setattr(port_train, "train", lambda joint, *a, **k: _raise(
        convert.params_tree(joint)))
    monkeypatch.setattr(jax_train, "train", lambda joint, *a, **k: _raise(
        joint))
    port = _capture(lambda: port_cli.main(argv))
    want = _capture(lambda: jax_cli.main(argv))
    assert set(port) == set(want) == {"diffusion_model", "rounding_fn",
                                      "embedding_fn"}
    for name in port:
        _assert_tree(port[name], want[name])


def _write_mnist_idx(root, n=64):
    from tinydiffusionmodels_torch.data.mnist import _synthetic_mnist

    images, labels = _synthetic_mnist(n, seed=0)
    root.mkdir(parents=True, exist_ok=True)
    for name, array in (("train-images-idx3-ubyte", images),
                        ("train-labels-idx1-ubyte", labels)):
        (root / name).write_bytes(
            struct.pack(">I", 0x0800 | array.ndim)
            + struct.pack(f">{array.ndim}I", *array.shape)
            + array.astype(np.uint8).tobytes())


@pytest.mark.parametrize("seed", [0, 7])
def test_mnist_cli_trains_from_the_jax_clis_weights(workdir, monkeypatch,
                                                    seed):
    """``mnist --train`` builds ``init_unet(substream(PRNGKey(--seed),
    "init"))``, as the JAX CLI does."""
    from tinydiffusionmodels_tpu import mnist as jax_cli
    from tinydiffusionmodels_tpu.train import mnist_train as jax_train
    from tinydiffusionmodels_torch import mnist as port_cli
    from tinydiffusionmodels_torch.train import mnist_train as port_train

    _write_mnist_idx(workdir / "digits")
    monkeypatch.setenv("TDM_DATA_LIMIT", "32")
    argv = ["--train", "--epochs", "1", "--batch_size", "16", "--ckpt",
            "m.pth", "--data_root", "digits", "--no_epoch_samples",
            "--seed", str(seed)]
    unet, init_unet = port_train.SimpleUNet, jax_train.init_unet
    monkeypatch.setattr(port_train, "SimpleUNet", lambda *a, **k: _raise(
        convert.unet_params_dict(unet(*a, **k))))
    monkeypatch.setattr(jax_train, "init_unet", lambda key: _raise(
        init_unet(key)))
    port = _capture(lambda: port_cli.main(argv))
    want = _capture(lambda: jax_cli.main(argv))
    _assert_tree(port, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_lm_train_starts_from_the_jax_weights(seed):
    """``train_lm`` starts from ``init_tiny_gpt(substream(PRNGKey(seed),
    "lm_init"))``: zero epochs return the initial weights in both."""
    from tinydiffusionmodels_tpu.train import lm_train as jax_lm
    from tinydiffusionmodels_torch.train import lm_train

    kw = dict(vocab_size=VOCAB, dim=DIM, n_heads=4, depth=2, max_len=9)
    chunks = np.random.default_rng(seed).integers(0, VOCAB, (6, 9))
    model = lm_train.train_lm(chunks, TinyGPTConfig(**kw), epochs=0,
                              seed=seed, device="cpu", log_fn=lambda s: None)
    want = jax_lm.train_lm(chunks, jax_ar_lm.TinyGPTConfig(**kw), epochs=0,
                           seed=seed, log_fn=lambda s: None)
    _assert_tree(convert.tiny_gpt_params_dict(model), want)


# --- draw_many and the text step's hoisted seeds -----------------------------

@pytest.mark.parametrize("fast", ["0", "1"])
def test_draw_many_equals_the_separate_draws(monkeypatch, fast):
    monkeypatch.setenv("TDM_FAST_NOISE", fast)
    key = rng.substream(rng.KeyPath(rng.prng_key(4), torch.tensor([9])), "x")
    win = ((1, 2), (0, 5), (3, 4))
    draws = [ops.rng.Draw("normal", key, (3, 5, 7), win, scale=0.02),
             ops.rng.Draw("uniform", key, (3, 5, 7), win, -0.3, 0.7),
             ops.rng.Draw("randint", key, (6,), None, 0, 1000,
                          dtype=torch.int32),
             ops.rng.Draw("counter_normal", key, (3, 5, 7), win),
             ops.rng.Draw("noise", key, (3, 5, 7), win),
             ops.rng.attention_seed_draw(key),
             ops.rng.Draw("key", key, (2,))]
    got = ops.rng.draw_many(draws)
    want = [ops.rng.normal(key, (3, 5, 7), window=win) * 0.02,
            ops.rng.uniform(key, (3, 5, 7), -0.3, 0.7, window=win),
            ops.rng.randint(key, (6,), 0, 1000, dtype=torch.int32),
            ops.rng.counter_normal(key, (3, 5, 7), window=win),
            ops.rng.draw_noise(key, (3, 5, 7), window=win),
            ops.rng.attention_seed(key), key.resolve()]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ops.rng.draw_many([]) == []


def test_hoisted_seeds_give_the_forward_its_own_seeds():
    """The denoiser in training mode with the attention seeds and the
    dropout key a training step draws at its top (``text_train.
    step_draws``) computes what it computes when it draws them itself
    from the step key's dropout substream, and ``step_draws``' timesteps
    and noise are ``draw_t_noise``'s."""
    from tinydiffusionmodels_torch.train import text_train

    _, tcfg = _cfgs("rope", False)
    model = TinyTransformer(tcfg, key=rng.prng_key(1))
    joint = torch.nn.ModuleDict({"diffusion_model": model})
    tokens = torch.zeros(3, 8, dtype=torch.long)
    step_key = rng.fold_in(rng.prng_key(2), 11)
    t, noise, seeds, derived = text_train.step_draws(joint, tokens, 1000,
                                                     step_key)
    t2, noise2 = text_train.draw_t_noise(joint, tokens, 1000, step_key)
    assert torch.equal(t, t2) and torch.equal(noise, noise2)
    assert len(seeds) == DEPTH
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 8, DIM)).astype(np.float32))
    dropout_key = rng.substream(step_key, "dropout")
    assert torch.equal(derived, dropout_key)
    hoisted = model(x, t, deterministic=False, key=derived,
                    attn_seeds=seeds)
    own = model(x, t, deterministic=False, key=dropout_key)
    assert torch.equal(hoisted, own)
    other = model(x, t, deterministic=False, key=dropout_key,
                  attn_seeds=[s + 1 for s in seeds])
    assert not torch.equal(hoisted, other)


def test_draw_descriptor_box_is_right_aligned():
    """``csrc/rng.cu``'s ``Draw`` as ``ops.rng`` fills it: 232 bytes, the
    box's dims right-aligned (unused outer dims of one element, stride 0),
    a CPU key's words by value, a mask's reciprocal RN(1 / div)."""
    assert ctypes.sizeof(ops.rng._Draw) == 232
    out = torch.empty(3, 7)
    key = rng.fold_in(rng.prng_key(5), 2)
    desc = ops.rng._descriptor(ops.rng._NORMAL, key, (4, 5, 7),
                               ((1, 3), (2, 1), (0, 7)), out)
    assert list(desc.size) == [1, 1, 3, 7]
    assert list(desc.gstride) == [0, 0, 35, 1]
    assert list(desc.start) == [0, 0, 1, 14]
    assert (desc.key[0], desc.key[1]) == rng.key_words(key)
    assert desc.base is None and desc.n_global == 140
    x = torch.ones(8, dtype=torch.bfloat16)
    div = ops.rng._divisor(0.9, torch.bfloat16)
    assert div == 0.8984375
    rcp = float(np.float32(1.0) / np.float32(div))
    desc = ops.rng._descriptor(ops.rng._COUNTER_KEEP, key, (8,), None, x, x,
                               div=div, rcp=rcp)
    assert desc.rcp == np.float32(1.0) / np.float32(desc.div)
