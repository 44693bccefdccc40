"""TinyGPT and its trainer in the torch package against the JAX package.

Same weights (the JAX package's init, carried over by
``io.convert.tiny_gpt_state_from_jax``) and the same numpy inputs go through
both packages on the CPU; the port's attention runs its plain version.
Tolerances: state dicts exact; logits and losses f32 ``atol = 1e-5``
(different summation orders); three AdamW steps' parameters ``atol = 1e-5``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from tinydiffusionmodels_tpu.models import (  # noqa: E402
    init_tiny_gpt,
    tiny_gpt_apply,
    tiny_gpt_decode_step,
    tiny_gpt_init_cache,
)
from tinydiffusionmodels_tpu.models.ar_lm import (  # noqa: E402
    TinyGPTConfig as JaxGPTConfig,
)
from tinydiffusionmodels_tpu.train import lm_train as jax_lm_train  # noqa: E402
from tinydiffusionmodels_tpu.train.optim import adamw as jax_adamw  # noqa: E402
from tinydiffusionmodels_tpu.train.state import TrainState  # noqa: E402
from tinydiffusionmodels_torch.io import convert  # noqa: E402
from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig  # noqa: E402
from tinydiffusionmodels_torch.train import lm_train, optim  # noqa: E402
from tinydiffusionmodels_torch.core.rng import prng_key  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
CFG_KW = dict(vocab_size=97, dim=64, n_heads=4, depth=2, max_len=24)
B, L = 4, 16


def _jax_params(seed=0):
    return init_tiny_gpt(jax.random.PRNGKey(seed), JaxGPTConfig(**CFG_KW))


def _port(params) -> TinyGPT:
    model = TinyGPT(TinyGPTConfig(**CFG_KW))
    model.load_state_dict(convert.tiny_gpt_state_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return model.eval()


def _ids(seed, shape=(B, L)):
    return np.random.default_rng(seed).integers(0, CFG_KW["vocab_size"],
                                                shape).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed):
    params = _jax_params(seed)
    ids = _ids(seed)
    want = np.asarray(tiny_gpt_apply(params, jnp.asarray(ids),
                                     JaxGPTConfig(**CFG_KW)))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (B, L, CFG_KW["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("attn_len", [None, L])
def test_decode_step_matches_jax_at_every_position(attn_len):
    """Teacher-forced KV-cached decode: the logits of every step, the
    cache in place, the position as a Python int."""
    params = _jax_params()
    jcfg = JaxGPTConfig(**CFG_KW)
    model = _port(params)
    ids = _ids(3)
    jcache = tiny_gpt_init_cache(jcfg, B)
    cache = model.init_cache(B)
    with torch.no_grad():
        for pos in range(L):
            want, jcache = tiny_gpt_decode_step(
                params, jcache, jnp.asarray(ids[:, pos]), jcfg, attn_len)
            got, cache = model.decode_step(
                cache, torch.from_numpy(ids[:, pos]).long(), attn_len)
            assert cache["pos"] == pos + 1
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATOL, err_msg=f"pos {pos}")
    # The cached decode is the full forward, position by position.
    with torch.no_grad():
        full = model(torch.from_numpy(ids).long())[:, -1]
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=ATOL)


def test_decode_step_rejects_positions_past_the_window():
    model = _port(_jax_params())
    cache = model.init_cache(1)
    cache["pos"] = 8
    with pytest.raises(ValueError, match="attention window 8"):
        model.decode_step(cache, torch.zeros(1, dtype=torch.long), 8)


def test_state_dict_round_trip_both_directions():
    params = jax.tree.map(np.asarray, _jax_params())
    back = convert.tiny_gpt_params_dict(_port(params))
    assert isinstance(back["blocks"], list)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(
        {**back, "blocks": tuple(back["blocks"])})
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # Port -> JAX tree -> port: the same state dict.
    model = TinyGPT(TinyGPTConfig(**CFG_KW),
                    key=prng_key(5))
    again = convert.tiny_gpt_state_from_jax(convert.tiny_gpt_params_dict(model))
    for key, val in model.state_dict().items():
        torch.testing.assert_close(again[key], val, rtol=0, atol=0)


def test_init_follows_jax_distributions():
    model = TinyGPT(TinyGPTConfig(vocab_size=500, dim=128, depth=1,
                                  max_len=300),
                    key=prng_key(0))
    sd = model.state_dict()
    assert abs(float(sd["tok_emb.weight"].std()) - 0.02) < 1e-3
    assert abs(float(sd["pos_emb.weight"].std()) - 0.01) < 1e-3
    bound = 1.0 / np.sqrt(128)
    assert float(sd["blocks.0.attn.qkv.weight"].abs().max()) <= bound
    assert "lm_head.bias" not in sd
    assert bool((sd["blocks.0.ln1.weight"] == 1).all())


def _jax_lm_loss(params, tokens):
    """``make_lm_train_step``'s loss."""
    logits = tiny_gpt_apply(params, tokens[:, :-1], JaxGPTConfig(**CFG_KW))
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1))


def test_lm_loss_gradients_match_jax():
    params = _jax_params()
    tokens = _ids(9, (B, L + 1))
    want_loss, grads = jax.value_and_grad(_jax_lm_loss)(params,
                                                         jnp.asarray(tokens))
    model = _port(params).train()
    loss = lm_train.lm_loss(model, torch.from_numpy(tokens).long())
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=0,
                               atol=ATOL)
    want = convert.tiny_gpt_state_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=ATOL, err_msg=name)


def test_three_train_steps_match_jax():
    """``lm_train_step`` with ``adamw(lr, weight_decay=0.01)`` against
    ``make_lm_train_step``: losses and parameters after three steps on the
    same batches."""
    lr = 3e-4
    params = _jax_params()
    jcfg = JaxGPTConfig(**CFG_KW)
    tx = jax_adamw(lr, weight_decay=0.01)
    state = TrainState.create(params, tx)
    step = jax_lm_train.make_lm_train_step(jcfg, tx)
    model = _port(params).train()
    opt = optim.adamw(model.parameters(), lr, weight_decay=0.01)
    for i in range(3):
        tokens = _ids(10 + i, (B, L + 1))
        state, want_loss = step(state, jnp.asarray(tokens))
        loss = lm_train.lm_train_step(model, opt,
                                      torch.from_numpy(tokens).long())
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=0,
                                   atol=ATOL)
    want = convert.tiny_gpt_state_from_jax(
        jax.tree.map(np.asarray, state.params))
    d = CFG_KW["dim"]
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("attn.qkv.weight") or name.endswith("attn.qkv.bias"):
            # The key projection's gradient sums dk_j over keys, and
            # sum_j dk_j = 0 (softmax ignores a per-row constant): exactly 0
            # for the key bias, and for a key weight a cancelling sum that
            # can fall to the rounding noise of both sides, which Adam
            # normalises to steps of up to lr each. Those rows are held to
            # three such steps (their gradients to 1e-5, in the test above).
            key = slice(d, 2 * d)
            np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                       atol=3 * lr, err_msg=name)
            got, ref = np.delete(got, key, axis=0), np.delete(ref, key, axis=0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL, err_msg=name)


def test_train_lm_learns_and_is_deterministic(capsys):
    """``train_lm`` on repeated text: the loss falls below the uniform
    loss, and the same seed gives the same weights."""
    ids = np.tile(np.arange(12) % 7, 40)
    chunks = ids[: (len(ids) // 9) * 9].reshape(-1, 9)
    cfg = TinyGPTConfig(vocab_size=7, dim=32, n_heads=2, depth=1, max_len=16)
    a = lm_train.train_lm(chunks, cfg, epochs=3, batch_size=8, lr=3e-3,
                          device="cpu", log_fn=print)
    out = capsys.readouterr().out
    assert out.count("[lm] epoch") == 3
    last = float(out.strip().splitlines()[-1].split("loss=")[1])
    assert last < np.log(7)
    b = lm_train.train_lm(chunks, cfg, epochs=3, batch_size=8, lr=3e-3,
                          device="cpu", log_fn=lambda s: None)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    assert not a.training


def test_train_lm_defaults_to_the_runtime_device(monkeypatch):
    """With no ``device``, ``train_lm`` trains on ``runtime.device()``: the
    card, or an error where there is none, unless ``TDM_PLATFORM=cpu``."""
    chunks = np.tile(np.arange(9) % 7, (8, 1))
    cfg = TinyGPTConfig(vocab_size=7, dim=32, n_heads=2, depth=1, max_len=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TDM_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="TDM_PLATFORM=cpu"):
        lm_train.train_lm(chunks, cfg, epochs=1, log_fn=lambda s: None)
    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    model = lm_train.train_lm(chunks, cfg, epochs=1, log_fn=lambda s: None)
    assert model.tok_emb.weight.device.type == "cpu"


def test_train_lm_rejects_an_empty_corpus():
    with pytest.raises(ValueError, match="empty corpus"):
        lm_train.train_lm(np.zeros((0, 9), np.int64), TinyGPTConfig(7))
