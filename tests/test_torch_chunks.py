"""The trainers' K-step chunks and the restructured reverse loop, on the CPU.

The chunked epoch loops (``text_train.TextSteps``, ``mnist_train.
MnistSteps``, ``train/chunks.py``) read the batch, the learning rate and the
rounding weight from device state through a step cursor, so that on the
card each step can be captured once as a CUDA graph and replayed. On the
CPU the same steps run eagerly, and must give exactly what the eager loop
of single ``train_step`` calls gave: the same step losses and parameters
(and EMA), bit for bit, whatever ``TDM_SCAN_CHUNK`` cuts the epoch into.
The reverse loop (``sample.ancestral.sample_loop``), now on device tables
and a device step index, must give exactly what the loop over host
timesteps gave. ``graphs.Step``'s bookkeeping (warm-up, capture, replays
and the launch counters) is checked against a stand-in for torch's CUDA
graph API.
"""

import contextlib
import json
import struct
import types

import numpy as np
import pytest
import torch
from torch import nn

from tinydiffusionmodels_torch import graphs
from tinydiffusionmodels_torch.core import make_schedule, rng
from tinydiffusionmodels_torch.core.diffusion import ddim_step, p_sample
from tinydiffusionmodels_torch.models import (
    LearnedEmbedding,
    LearnedRounding,
    SimpleUNet,
    TinyTransformer,
    TransformerConfig,
)
from tinydiffusionmodels_torch.ops import resblock
from tinydiffusionmodels_torch.sample.ancestral import Sampler, sample_loop
from tinydiffusionmodels_torch.sample.text import make_denoiser
from tinydiffusionmodels_torch.train import chunks, mnist_train, text_train
from tinydiffusionmodels_torch.train.optim import (
    adamw,
    cosine_warmup_lambda,
    dynamic_rounding_weight_schedule,
)
from tinydiffusionmodels_torch.core.rng import prng_key, substream

torch.set_num_threads(1)

DIM, VOCAB, L, B = 16, 40, 8, 4
TRAIN, VAL = 52, 8      # 13 steps an epoch at batch 4: a remainder for 7, 25


def _joint(self_cond: bool) -> nn.ModuleDict:
    cfg = TransformerConfig(dim=DIM, n_heads=2, depth=1, dropout=0.1,
                            ffn_dim=32, timesteps=1000, self_cond=self_cond)
    return nn.ModuleDict({
        "diffusion_model": TinyTransformer(
            cfg, key=substream(prng_key(0), "diffusion")),
        "rounding_fn": LearnedRounding(
            DIM, VOCAB, key=substream(prng_key(0), "rounding")),
        "embedding_fn": LearnedEmbedding(
            VOCAB, DIM, key=substream(prng_key(0), "embedding")),
    })


def _text_reference(joint, train_chunks, *, epochs, lr, warmup, ema_decay,
                    seed, **loss_kwargs):
    """The epoch loop the chunks replace: one ``train_step`` per Python
    iteration, ``LambdaLR`` after each, the EMA after each."""
    from tinydiffusionmodels_torch.data.loader import batch_iterator

    steps = len(train_chunks) // B
    optimizer = adamw(joint.parameters(), lr, weight_decay=1e-4)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, cosine_warmup_lambda(warmup, steps * epochs))
    ema = None
    if ema_decay is not None:
        import copy

        ema = copy.deepcopy(joint).requires_grad_(False)
    train_key = rng.substream(rng.prng_key(seed), "train")
    self_cond = joint["diffusion_model"].cfg.self_cond
    train_dev = torch.as_tensor(train_chunks, dtype=torch.long)
    losses = []
    for epoch in range(epochs):
        w = dynamic_rounding_weight_schedule(epoch, epochs, 1.0)
        for rows in batch_iterator(np.arange(len(train_chunks)), B,
                                   seed=seed, epoch=epoch):
            step = len(losses)
            coin = self_cond and text_train.coin(train_key, step)
            losses.append(text_train.train_step(
                joint, optimizer, train_dev[torch.as_tensor(rows)], w,
                rng.fold_in(train_key, step), self_cond_coin=coin,
                **loss_kwargs))
            scheduler.step()
            if ema is not None:
                with torch.no_grad():
                    torch._foreach_mul_(list(ema.parameters()), ema_decay)
                    torch._foreach_add_(list(ema.parameters()),
                                        list(joint.parameters()),
                                        alpha=1.0 - ema_decay)
    return torch.stack(losses).numpy(), (ema if ema is not None else joint)


# name: (self_cond, ema_decay, compute_dtype, TDM_SCAN_CHUNK)
TEXT_CASES = {
    "chunk1": (False, None, None, "1"),
    "chunk7_remainder": (False, None, None, "7"),
    "chunk25_one_short_chunk": (False, None, None, "25"),
    "self_cond": (True, None, None, "7"),
    "ema": (False, 0.9, None, "7"),
    "bf16": (False, None, torch.bfloat16, "7"),
    "self_cond_ema_bf16": (True, 0.9, torch.bfloat16, "25"),
}


@pytest.mark.parametrize("name", sorted(TEXT_CASES))
def test_chunked_text_train_equals_single_steps(name, tmp_path, monkeypatch):
    """``text_train.train`` in chunks gives the step losses and the final
    parameters (the EMA's with ``ema_decay``) of the same number of single
    ``train_step`` calls, bit for bit, over two epochs of 13 steps."""
    self_cond, ema_decay, dtype, chunk = TEXT_CASES[name]
    monkeypatch.setenv("TDM_SCAN_CHUNK", chunk)
    monkeypatch.setenv("TDM_PROGRESS_EVERY", "1")
    data = np.random.default_rng(0).integers(0, VOCAB, (TRAIN + VAL, L))
    kw = dict(epochs=2, lr=1e-2, warmup=5, ema_decay=ema_decay, seed=3)
    sched = make_schedule()
    lines = []
    result = text_train.train(
        _joint(self_cond), data[:TRAIN], data[TRAIN:], sched=sched,
        ckpt_path=str(tmp_path / "t.pth"), batch_size=B, epochs=2,
        lr=kw["lr"], warmup_steps=kw["warmup"], ema_decay=ema_decay,
        seed=kw["seed"], compute_dtype=dtype, log_fn=lines.append)
    want_losses, want = _text_reference(
        _joint(self_cond), data[:TRAIN], sched=sched,
        use_learned_embeddings=True, pretrained_matrix=None,
        compute_dtype=dtype, **kw)
    assert result.step_losses.shape == (26, 3)
    np.testing.assert_array_equal(result.step_losses, want_losses)
    for (n, p), (_, q) in zip(result.joint.named_parameters(),
                              want.named_parameters()):
        assert torch.equal(p, q), n
    # One progress line a chunk (TDM_PROGRESS_EVERY=1), per epoch.
    progress = [s for s in lines if s.startswith("[epoch 1] step")]
    assert len(progress) == len(chunks.chunk_lengths(13, int(chunk)))


def _fake_optimizer(lr):
    return types.SimpleNamespace(param_groups=[{"lr": lr}])


def test_device_lr_table_is_lambdalrs():
    """The learning rates a chunk runner takes, from ``lr_at`` (base lr
    times ``cosine_warmup_lambda``), are ``LambdaLR``'s step by step, through
    the warm-up and the cosine and across epochs: the host table exactly,
    and the device table (a float32 tensor learning rate, as AdamW holds it
    on the card) as those values rounded to float32."""
    lr, warmup, steps, epochs = 3e-3, 7, 10, 3
    lam = cosine_warmup_lambda(warmup, steps * epochs)
    optimizer = torch.optim.AdamW([nn.Parameter(torch.zeros(2))], lr=lr)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lam)
    want = []
    for _ in range(steps * epochs):
        want.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        scheduler.step()

    def lr_at(step):
        return lr * lam(step)

    device_lr = torch.zeros(())
    state = chunks.EpochSteps(lambda _: None, optimizer=_fake_optimizer(
        device_lr), steps=steps, batch_size=1, loss_width=1, device="cpu",
        lr_at=lr_at)
    assert state.device_lr
    got, host = [], []
    for epoch in range(epochs):
        state.start(np.zeros((steps, 1), np.int64), epoch * steps)
        host += state.lr_values
        for _ in range(steps):
            state.set_lr()
            got.append(float(device_lr))
            state.finish(torch.zeros(1))
    assert host == want
    np.testing.assert_array_equal(np.float32(got), np.float32(want))
    assert 0.0 in want[:1] and max(want) == pytest.approx(lr)


@pytest.mark.parametrize("steps, chunk, want", [
    (13, 1, [1] * 13), (13, 7, [7, 6]), (13, 25, [13]), (50, 25, [25, 25]),
    (51, 25, [25, 25, 1]), (0, 25, []),
])
def test_chunk_lengths_are_the_jax_flushes(steps, chunk, want):
    """K steps a chunk, then the remainder (the JAX trainers' ``flush``)."""
    assert chunks.chunk_lengths(steps, chunk) == want


def _write_mnist_idx(root, n):
    from tinydiffusionmodels_torch.data.mnist import _synthetic_mnist

    images, labels = _synthetic_mnist(n, seed=0)
    root.mkdir(parents=True, exist_ok=True)
    for name, array in (("train-images-idx3-ubyte", images),
                        ("train-labels-idx1-ubyte", labels)):
        (root / name).write_bytes(
            struct.pack(">I", 0x0800 | array.ndim)
            + struct.pack(f">{array.ndim}I", *array.shape)
            + array.astype(np.uint8).tobytes())


@pytest.fixture()
def mnist_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_mnist_idx(tmp_path / "digits", 96)
    monkeypatch.setenv("TDM_DATA_LIMIT", "88")   # 11 steps of 8
    monkeypatch.setenv("TDM_PROGRESS_EVERY", "0")
    return tmp_path


def _mnist_train(ema_decay=None, dtype=None, **kw):
    return mnist_train.train(
        epochs=2, batch_size=8, ckpt_path="m.pth", sample_every_epoch=False,
        data_root="digits", seed=5, ema_decay=ema_decay, compute_dtype=dtype,
        device="cpu", log_fn=lambda *a: None, **kw)


# name: (ema_decay, compute_dtype, TDM_SCAN_CHUNK)
MNIST_CASES = {"chunk1": (None, None, "1"), "chunk4_remainder": (None, None,
               "4"), "chunk25": (None, None, "25"),
               "ema": (0.9, None, "4"), "bf16": (None, torch.bfloat16, "4")}


@pytest.mark.parametrize("name", sorted(MNIST_CASES))
def test_chunked_mnist_train_equals_single_steps(name, mnist_dir,
                                                 monkeypatch):
    """``mnist_train.train`` in chunks gives the step losses and final
    weights (the EMA's with ``ema_decay``) of single ``train_step`` calls
    in ``batch_iterator``'s order, bit for bit, over two epochs."""
    import copy

    from tinydiffusionmodels_torch.data import load_mnist, normalize_mnist

    ema_decay, dtype, chunk = MNIST_CASES[name]
    monkeypatch.setenv("TDM_SCAN_CHUNK", chunk)
    result = _mnist_train(ema_decay, dtype)

    images, _, _ = load_mnist("digits", train=True)
    data = torch.as_tensor(normalize_mnist(images[:88]))
    sched = make_schedule()
    # The trainer's init: init_unet(substream(PRNGKey(seed), "init")).
    model = SimpleUNet(sched.timesteps,
                       key=substream(prng_key(5), "init"))
    optimizer = adamw(model.parameters(), 1e-3, weight_decay=0.01)
    ema = copy.deepcopy(model).requires_grad_(False) if ema_decay else None
    train_key = rng.substream(rng.prng_key(5), "train")
    want = []
    for epoch in range(2):
        order = mnist_train.epoch_order(88, 8, seed=5, epoch=epoch,
                                        device="cpu")
        for rows in order:
            want.append(mnist_train.train_step(
                model, optimizer, data[rows], sched,
                rng.fold_in(train_key, len(want)), compute_dtype=dtype))
            if ema is not None:
                mnist_train.ema_update(ema, model, ema_decay)
    np.testing.assert_array_equal(result.step_losses,
                                  torch.stack(want).numpy())
    final = ema if ema is not None else model
    for (n, p), (_, q) in zip(result.model.named_parameters(),
                              final.named_parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("chunk, lengths", [("4", [4, 4, 3]),
                                            ("25", [11])])
def test_mnist_record_loss_is_the_last_chunks_mean(chunk, lengths, mnist_dir,
                                                   monkeypatch):
    """The metrics record's and the epoch line's ``loss`` are the mean
    step loss of the epoch's last chunk, as the JAX trainer logs
    ``float(loss)`` after its last flush; the chunks are K steps, then the
    remainder."""
    monkeypatch.setenv("TDM_SCAN_CHUNK", chunk)
    seen = []
    run = mnist_train.MnistSteps.run

    def spy(self, n):
        seen.append(n)
        return run(self, n)

    monkeypatch.setattr(mnist_train.MnistSteps, "run", spy)
    lines = []
    result = mnist_train.train(
        epochs=1, batch_size=8, ckpt_path="m.pth", sample_every_epoch=False,
        data_root="digits", seed=5, metrics_path="m.jsonl", device="cpu",
        log_fn=lines.append)
    assert seen == lengths
    last = result.step_losses[-lengths[-1]:]
    record = json.loads((mnist_dir / "m.jsonl").read_text())
    assert record["loss"] == float(last.mean()) == result.epochs[0]["loss"]
    assert record["steps"] == 11
    assert lines[-1].endswith(f"loss~{float(last.mean()):.4f}")
    if len(lengths) > 1:   # no longer the epoch's mean
        assert record["loss"] != float(result.step_losses.mean())


def _old_sample_loop(denoise_fn, sched, shape, *, method, num_steps=None,
                     eta=0.0, self_cond=False, key=None, x_T=None,
                     noise_fn=None):
    """The reverse loop over host timesteps that ``sample_loop`` replaced
    (temperature 1), drawing as the JAX sampler does: x_T from
    ``split(key)[0]``, step t's noise from ``fold_in(split(key)[1], t)``."""
    device = sched.betas.device
    if key is not None:
        init_key, loop_key = rng.split(key)

    def normal(t):
        return rng.normal(rng.fold_in(loop_key, t), shape)

    x = (rng.normal(init_key, shape) if x_T is None
         else x_T.to(device=device, dtype=torch.float32))
    noise_fn = noise_fn or normal
    batch = shape[0]
    sc = torch.zeros(shape, device=device) if self_cond else None

    def call(x, t_b, sc):
        if self_cond:
            return denoise_fn(x, t_b, sc)
        return denoise_fn(x, t_b), sc

    def rows(ts):
        r = torch.as_tensor(np.ascontiguousarray(ts), dtype=torch.long)
        return r.to(device)[:, None].expand(len(ts), batch)

    if method == "ancestral":
        ts = np.arange(sched.timesteps - 1, -1, -1)
        t_rows = rows(ts)
        for i, t in enumerate(ts.tolist()):
            eps, sc = call(x, t_rows[i], sc)
            x = p_sample(sched, x, t_rows[i], eps, noise_fn(t))
        return x
    if method == "dpm++":
        n = num_steps or 20
        ts = np.linspace(0, sched.timesteps - 1, n + 1).round().astype(
            np.int64)[::-1]
        t_rows = rows(ts)
        acp = sched.alphas_cumprod[t_rows[:, 0]]
        alphas = torch.sqrt(acp)
        sigmas = torch.sqrt(torch.clamp(1.0 - acp, min=1e-12))
        lams = torch.log(alphas / sigmas)
        x0_prev = h_prev = None
        for i in range(n):
            eps, sc = call(x, t_rows[i], sc)
            x0 = (x - sigmas[i] * eps) / alphas[i]
            h = lams[i + 1] - lams[i]
            d = x0 if i == 0 else x0 + (0.5 / (h_prev / h)) * (x0 - x0_prev)
            x = (sigmas[i + 1] / sigmas[i]) * x - alphas[i + 1] * torch.expm1(
                -h) * d
            x0_prev, h_prev = x0, h
        return x
    n = num_steps or 50
    ts = np.linspace(0, sched.timesteps - 1, n).round().astype(np.int64)[::-1]
    ts_prev = np.concatenate([ts[1:], [-1]])
    t_rows, tp_rows = rows(ts), rows(ts_prev)
    for i, t in enumerate(ts.tolist()):
        eps, sc = call(x, t_rows[i], sc)
        x = ddim_step(sched, x, t_rows[i], tp_rows[i], eps, eta=eta,
                      noise=noise_fn(t) if eta > 0.0 else None)
    return x


SAMPLER_CASES = [("ancestral", None, 0.0), ("ddim", 7, 0.0),
                 ("ddim", 7, 0.5), ("dpm++", 6, 0.0)]


@pytest.mark.parametrize("denoiser", ["unet", "text", "text_self_cond"])
@pytest.mark.parametrize("method, steps, eta", SAMPLER_CASES)
def test_sample_loop_gives_the_host_loops_results(method, steps, eta,
                                                  denoiser):
    """``sample_loop`` on device tables and a step index equals the loop
    over host timesteps bit for bit: from a key, and from ``x_T`` and
    ``noise_fn`` (the parity tests' hooks)."""
    sched = make_schedule(40)
    if denoiser == "unet":
        fn = SimpleUNet(40, key=prng_key(0)).eval()
        shape, self_cond = (2, 28, 28, 1), False
    else:
        self_cond = denoiser == "text_self_cond"
        model = TinyTransformer(
            TransformerConfig(dim=DIM, n_heads=2, depth=1, ffn_dim=32,
                              timesteps=40, self_cond=self_cond),
            key=prng_key(1)).eval()
        if self_cond:
            with torch.no_grad():
                model.selfcond_proj.weight.normal_(
                    0.0, 0.1, generator=torch.Generator().manual_seed(2))
        fn, shape = make_denoiser(model, sched), (2, L, DIM)
    kw = dict(method=method, num_steps=steps, eta=eta, self_cond=self_cond)
    with torch.inference_mode():
        got = sample_loop(fn, sched, shape, key=rng.prng_key(4), **kw)
        want = _old_sample_loop(fn, sched, shape, key=rng.prng_key(4), **kw)
        assert torch.equal(got, want)
        x_T = torch.randn(shape, generator=torch.Generator().manual_seed(5))

        def noise_fn(t):
            return torch.full(shape, t / 100.0)

        got = sample_loop(fn, sched, shape, x_T=x_T, noise_fn=noise_fn, **kw)
        want = _old_sample_loop(fn, sched, shape, x_T=x_T,
                                noise_fn=noise_fn, **kw)
        assert torch.equal(got, want)


@pytest.mark.parametrize("method, steps, eta", SAMPLER_CASES)
def test_a_sampler_called_again_continues_its_generator(method, steps, eta):
    """A ``Sampler`` kept across calls (its state reset each call, its key
    in a device buffer) gives what ``sample_loop`` gives for each call's
    key, and by default draws from the key it was made with."""
    sched = make_schedule(30)
    model = TinyTransformer(
        TransformerConfig(dim=DIM, n_heads=2, depth=1, ffn_dim=32,
                          timesteps=30, self_cond=True),
        key=prng_key(1)).eval()
    with torch.no_grad():
        model.selfcond_proj.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(2))
    fn, shape = make_denoiser(model, sched), (2, L, DIM)
    kw = dict(method=method, num_steps=steps, eta=eta, self_cond=True)
    keys = [rng.prng_key(s) for s in (3, 4, 3)]
    sampler = Sampler(fn, sched, shape, key=keys[0], **kw)
    got = [sampler(k) for k in keys] + [sampler()]
    with torch.inference_mode():
        want = [sample_loop(fn, sched, shape, key=k, **kw)
                for k in keys + keys[:1]]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])


class _FakeCuda:
    """Stand-ins for torch.cuda's graph API: a capture runs the step's
    Python (as torch's does) but launches nothing, and each replay records
    itself."""

    def __init__(self):
        self.capturing = False
        self.graphs = []
        cuda = self

        class Graph:
            def __init__(self):
                self.replays = 0
                cuda.graphs.append(self)

            def capture_begin(self):
                cuda.capturing = True

            def capture_end(self):
                cuda.capturing = False

            def replay(self):
                self.replays += 1

        def stream_(device=None):
            return types.SimpleNamespace(wait_stream=lambda other: None)

        self.CUDAGraph = Graph
        self.Stream = self.current_stream = stream_
        self.stream = lambda s: contextlib.nullcontext()


@pytest.fixture()
def fake_cuda(monkeypatch):
    fake = _FakeCuda()
    for name in ("CUDAGraph", "Stream", "current_stream", "stream"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    monkeypatch.setattr(resblock, "launches", 0)
    return fake


def test_step_warms_up_captures_once_and_counts_replays(fake_cuda):
    """``graphs.Step`` on a CUDA device: ``warmup`` eager calls, then one
    capture, then a replay per call; the launch counters count each
    replay's launches and none for the capture itself."""
    ran = []

    def step():
        ran.append(fake_cuda.capturing)
        resblock.launches += 4      # a wrapper's count: four launches

    s = graphs.Step(step, "cuda", warmup=2)
    for _ in range(5):
        s()
    assert ran == [False, False, True]        # two eager, one captured
    assert s.captured and s.delta[3] == 4 and sum(s.delta) == 4
    (graph,) = fake_cuda.graphs
    assert graph.replays == 3
    assert resblock.launches == 5 * 4


def test_a_failed_capture_raises_and_counts_nothing(fake_cuda):
    """A step that raises while captured raises to the caller, ends the
    capture, leaves the counters as they were and is not replayed."""
    calls = []

    def step():
        calls.append(1)
        resblock.launches += 4
        if fake_cuda.capturing:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    s = graphs.Step(step, "cuda", warmup=1)
    s()
    with pytest.raises(RuntimeError, match="capturing"):
        s()
    assert not fake_cuda.capturing and not s.captured
    assert resblock.launches == 4


def test_no_garbage_collection_inside_a_capture(fake_cuda):
    """The cycle collector is off while a step is captured (it could free
    another step's graph there, which CUDA refuses mid-capture) and on
    again after the capture, whether it succeeds or fails."""
    import gc

    seen = []

    def step():
        seen.append(gc.isenabled())
        if fake_cuda.capturing and len(seen) == 2:
            raise RuntimeError("failed capture")

    assert gc.isenabled()
    failing = graphs.Step(step, "cuda", warmup=1)
    failing()
    with pytest.raises(RuntimeError, match="failed capture"):
        failing()
    assert seen == [True, False] and gc.isenabled()
    seen.clear()
    s = graphs.Step(lambda: seen.append(gc.isenabled()), "cuda", warmup=1)
    for _ in range(3):
        s()
    assert seen == [True, False] and gc.isenabled()


def test_eager_step_and_cpu_step_never_capture(fake_cuda):
    """``eager=True`` and CPU devices run the function on every call."""
    for kw in ({"device": "cuda", "eager": True}, {"device": "cpu"}):
        ran = []
        s = graphs.Step(lambda: ran.append(1), warmup=1, **kw)
        for _ in range(4):
            s()
        assert len(ran) == 4 and not s.captured
    assert fake_cuda.graphs == []
