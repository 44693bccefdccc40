"""The torch package's CLI (``python -m tinydiffusionmodels_torch.shakespeare``)
on the CPU (``TDM_PLATFORM=cpu``), on checkpoints the JAX package wrote.

Also proves the port imports nothing of jax, which the GPU machine lacks: a
subprocess with ``sys.modules["jax"] = None`` imports every module of the
package and runs the CLI.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tinydiffusionmodels_tpu.data.tokenizer import CharTokenizer  # noqa: E402
from tinydiffusionmodels_tpu.io import save_checkpoint  # noqa: E402
from tinydiffusionmodels_tpu.models import (  # noqa: E402
    init_learned_embedding,
    init_learned_rounding,
    init_tiny_transformer,
)
from tinydiffusionmodels_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JaxConfig,
)
import tinydiffusionmodels_torch  # noqa: E402
from tinydiffusionmodels_torch import shakespeare as port_cli  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CORPUS = "To be, or not to be, that is the question.\n" * 4


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    monkeypatch.delenv("AIP_MODEL_DIR", raising=False)
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "tiny_shakespeare.txt").write_text(CORPUS)
    return tmp_path


def _write_jax_checkpoint(path, *, dim=32, pos_emb="none", self_cond=False,
                          **meta):
    """A checkpoint in train/text_train._checkpoint_dict's layout, written
    by the JAX package's save_checkpoint."""
    from tinydiffusionmodels_tpu.train import text_train

    tok = CharTokenizer(CORPUS)
    cfg = JaxConfig(dim=dim, n_heads=4, depth=2, ffn_dim=64,
                    pos_emb=pos_emb, self_cond=self_cond)
    joint = {
        "diffusion_model": init_tiny_transformer(jax.random.PRNGKey(0), cfg),
        "rounding_fn": init_learned_rounding(jax.random.PRNGKey(1), dim,
                                             tok.vocab_size),
        "embedding_fn": init_learned_embedding(jax.random.PRNGKey(2),
                                               tok.vocab_size, dim),
    }
    save_checkpoint(
        text_train._checkpoint_dict(
            joint, epoch=1, use_learned_embeddings=True,
            tokenizer_state=tok.state(), self_cond=self_cond,
            pos_emb=pos_emb, **meta,
        ),
        str(path),
    )


SAMPLE = ["--sample", "--model_id", "char", "--data_root", "data",
          "--n", "2", "--seq_len", "8"]


@pytest.mark.parametrize("sampler", [
    ["--sampler", "ddim", "--steps", "4"],
    ["--sampler", "dpm++", "--steps", "3", "--clamp"],
])
def test_samples_jax_checkpoint(workdir, sampler):
    _write_jax_checkpoint(workdir / "ckpt.pth")
    z = port_cli.main([*SAMPLE, "--ckpt", "ckpt.pth", *sampler])
    assert tuple(z.shape) == (2, 8, 32)
    assert torch.isfinite(z).all()
    for i in range(2):
        assert (workdir / "samples" / f"sample_{i}.txt").exists()


def test_checkpoint_self_configuration(workdir, capsys):
    _write_jax_checkpoint(
        workdir / "ckpt.pth", dim=48, pos_emb="rope", self_cond=True,
        parameterization="x0", embed_norm="zscore", noise_schedule="sqrt",
    )
    z = port_cli.main([*SAMPLE, "--ckpt", "ckpt.pth", "--sampler", "ddim",
                       "--steps", "3"])
    out = capsys.readouterr().out
    assert "[ckpt] embed_dim=48 (from checkpoint)" in out
    assert "[ckpt] pos_emb=rope (from checkpoint)" in out
    assert "[ckpt] self_cond=True (from checkpoint)" in out
    assert "[ckpt] parameterization=x0 (from checkpoint)" in out
    assert "[ckpt] noise_schedule=sqrt (from checkpoint)" in out
    assert tuple(z.shape) == (2, 8, 48)


def test_legacy_bare_checkpoint(workdir, capsys):
    from tinydiffusionmodels_tpu.io.checkpoint import transformer_to_state_dict

    cfg = JaxConfig(dim=32, n_heads=4, depth=3, ffn_dim=64)
    save_checkpoint(
        transformer_to_state_dict(
            init_tiny_transformer(jax.random.PRNGKey(0), cfg)),
        "legacy.pth",
    )
    port_cli.main([*SAMPLE, "--ckpt", "legacy.pth", "--embed_dim", "32",
                   "--sampler", "ddim", "--steps", "3"])
    assert "old checkpoint format" in capsys.readouterr().out.lower()
    assert (workdir / "samples" / "sample_1.txt").exists()


def test_jax_cli_reads_port_checkpoint(workdir):
    """A checkpoint the port writes (text_checkpoint_dict) samples through
    the JAX CLI, and its weights come back unchanged."""
    from tinydiffusionmodels_tpu import shakespeare as jax_cli
    from tinydiffusionmodels_tpu.io import load_checkpoint
    from tinydiffusionmodels_torch.io import text_checkpoint_dict
    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )

    tok = CharTokenizer(CORPUS)
    gen = torch.Generator().manual_seed(0)
    model = TinyTransformer(
        TransformerConfig(dim=32, depth=2, ffn_dim=64, pos_emb="abs",
                          max_len=16), generator=gen)
    ckpt = text_checkpoint_dict(
        model, LearnedRounding(32, tok.vocab_size, generator=gen),
        LearnedEmbedding(tok.vocab_size, 32, generator=gen),
        tokenizer_state=tok.state(),
    )
    assert ckpt["pos_emb"] == "abs"
    save_checkpoint(ckpt, "port.pth")
    back = load_checkpoint("port.pth")
    for key, val in model.state_dict().items():
        np.testing.assert_array_equal(back["diffusion_model"][key],
                                      val.numpy())
    jax_cli.main([*SAMPLE, "--ckpt", "port.pth", "--use_learned_embeddings",
                  "--sampler", "ddim", "--steps", "2"])
    assert (workdir / "samples" / "sample_0.txt").exists()


def test_port_rope_checkpoint_round_trip(workdir, capsys):
    """A rope, self-conditioned model saved by the port keeps its positions
    through the checkpoint (rope has no weights, only the 'pos_emb' key):
    the CLI's samples equal those of the model it saved."""
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.io import text_checkpoint_dict
    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )
    from tinydiffusionmodels_torch.sample.text import (
        sample_diffusion_embeddings,
    )

    tok = CharTokenizer(CORPUS)
    gen = torch.Generator().manual_seed(0)
    model = TinyTransformer(
        TransformerConfig(dim=32, depth=2, ffn_dim=64, pos_emb="rope",
                          self_cond=True), generator=gen).eval()
    with torch.no_grad():  # a nonzero projection, so self_cond counts
        model.selfcond_proj.weight.normal_(0.0, 0.1, generator=gen)
    save_checkpoint(
        text_checkpoint_dict(
            model, LearnedRounding(32, tok.vocab_size, generator=gen),
            LearnedEmbedding(tok.vocab_size, 32, generator=gen),
            tokenizer_state=tok.state(),
        ),
        "port.pth",
    )
    z = port_cli.main([*SAMPLE, "--ckpt", "port.pth", "--sampler", "ddim",
                       "--steps", "3", "--seed", "3"])
    out = capsys.readouterr().out
    assert "[ckpt] pos_emb=rope (from checkpoint)" in out
    assert "[ckpt] self_cond=True (from checkpoint)" in out
    want = sample_diffusion_embeddings(
        model, make_schedule(), n=2, seq_len=8, embed_dim=32, method="ddim",
        num_steps=3, generator=torch.Generator().manual_seed(3),
    )
    torch.testing.assert_close(z, want, rtol=0, atol=0)


UNPORTED = "not yet ported to the torch package"


@pytest.mark.parametrize("argv, match", [
    # --train itself is ported; its resume state (optax's pytree) is not.
    pytest.param(["--train", "--resume"], UNPORTED, id="--train"),
    # --guided_sample is ported with TinyGPT; the Hugging Face base LM is not.
    pytest.param(["--guided_sample", "--base_lm", "hf"], UNPORTED,
                 id="--guided_sample"),
    # --seq_parallel is ported: a seq_len the ring does not divide exits with
    # the JAX CLI's message (a ring of 2 laid out without processes).
    pytest.param(["--train", "--seq_parallel", "--seq_len", "9"],
                 "--seq_parallel needs seq_len divisible by the ring size 2",
                 id="--seq_parallel"),
])
def test_unported_modes_exit_nonzero(workdir, monkeypatch, argv, match):
    from tinydiffusionmodels_torch import parallel
    from tinydiffusionmodels_torch.parallel import mesh

    monkeypatch.setattr(parallel, "make_mesh",
                        lambda axes=None: mesh.make_mesh(axes, world=2))
    with pytest.raises(SystemExit, match=match):
        port_cli.main([*argv, "--ckpt", "ckpt.pth"])


def _assert_profile(logdir: Path, op: str) -> None:
    """``runtime.profile_trace``'s output: a Chrome trace and the per-op
    table, which lists ``op``."""
    import json

    trace = json.loads((logdir / "trace.json").read_text())
    assert trace["traceEvents"]
    assert op in (logdir / "ops.txt").read_text()


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_profile_dir_traces_the_text_cli(workdir, capsys, sampler):
    """``--sample --profile_dir`` writes trace.json and ops.txt (the flash
    attention's plain version's matmul among the ops on the CPU) and
    samples what the unprofiled call samples."""
    _write_jax_checkpoint(workdir / "ckpt.pth")
    argv = [*SAMPLE, "--ckpt", "ckpt.pth", "--sampler", sampler, "--steps",
            "2"]
    z = port_cli.main([*argv, "--profile_dir", "prof"])
    assert "[profile] wrote trace.json and ops.txt to prof" in \
        capsys.readouterr().out
    _assert_profile(workdir / "prof", "aten::matmul")
    torch.testing.assert_close(z, port_cli.main(argv), rtol=0, atol=0)


def test_train_writes_checkpoints_both_clis_sample(workdir, monkeypatch):
    """``--train`` on the built-in corpus cut by TDM_DATA_LIMIT writes the
    best and final checkpoints and the metrics JSONL; the port's and the
    JAX package's ``--sample`` both read the final checkpoint."""
    import json

    from tinydiffusionmodels_tpu import shakespeare as jax_cli
    from tinydiffusionmodels_tpu.io import load_checkpoint

    monkeypatch.setenv("TDM_DATA_LIMIT", "4000")
    (workdir / "empty").mkdir()
    common = ["--model_id", "char", "--data_root", "empty", "--seq_len", "16",
              "--ckpt", "t.pth"]
    result = port_cli.main([
        "--train", *common, "--epochs", "1", "--batch_size", "4",
        "--embed_dim", "32", "--depth", "1", "--warmup_steps", "5",
        "--metrics_path", "m.jsonl",
    ])
    # 4000 chars -> 250 chunks of 16 -> 225 training (56 steps of 4) and 25
    # validation chunks.
    assert result.steps == 56 and result.step_losses.shape == (56, 3)
    assert np.isfinite(result.step_losses).all()
    for path in ("t.pth", "t_best.pth"):
        ckpt = load_checkpoint(path)
        assert set(ckpt) >= {"diffusion_model", "rounding_fn", "embedding_fn",
                             "tokenizer", "epoch", "parameterization"}
    assert load_checkpoint("t.pth")["final_training"] is True
    record = json.loads((workdir / "m.jsonl").read_text().splitlines()[0])
    assert record["steps"] == 56 and np.isfinite(record["val_total"])

    sample = ["--sample", *common, "--n", "2", "--sampler", "ddim",
              "--steps", "3"]
    z = port_cli.main(sample)
    assert tuple(z.shape) == (2, 16, 32) and torch.isfinite(z).all()
    (workdir / "samples" / "sample_0.txt").unlink()
    jax_cli.main(sample)
    assert (workdir / "samples" / "sample_0.txt").exists()


def test_train_bf16_writes_f32_checkpoints(workdir, monkeypatch):
    """``--train --dtype bf16``: one tiny epoch in bf16 on the CPU writes
    f32 checkpoints, which the port's ``--sample`` and the JAX package's
    reader load."""
    from tinydiffusionmodels_tpu.io import load_checkpoint

    monkeypatch.setenv("TDM_DATA_LIMIT", "2000")
    (workdir / "empty").mkdir()
    common = ["--model_id", "char", "--data_root", "empty", "--seq_len", "16",
              "--ckpt", "b.pth"]
    result = port_cli.main([
        "--train", *common, "--dtype", "bf16", "--epochs", "1",
        "--batch_size", "8", "--embed_dim", "32", "--depth", "1",
        "--warmup_steps", "5",
    ])
    # 2000 chars -> 125 chunks of 16 -> 112 training (14 steps of 8).
    assert result.steps == 14 and np.isfinite(result.step_losses).all()
    assert all(p.dtype == torch.float32
               for p in result.joint.parameters())
    for path in ("b.pth", "b_best.pth"):
        ckpt = load_checkpoint(path)
        for part in ("diffusion_model", "rounding_fn", "embedding_fn"):
            for key, value in ckpt[part].items():
                assert np.asarray(value).dtype == np.float32, (path, key)
    z = port_cli.main(["--sample", *common, "--n", "2", "--sampler", "ddim",
                       "--steps", "3"])
    assert tuple(z.shape) == (2, 16, 32) and z.dtype == torch.float32
    assert torch.isfinite(z).all()


def test_train_sample_at_embed_dim_48(workdir, monkeypatch):
    """``--train --sample --embed_dim 48``: four heads of width 12, a width
    the JAX package's CLI tests also train at (tests/test_cli.py). The port
    trains, then samples from what it trained, in one call; the JAX CLI
    samples the same checkpoint."""
    from tinydiffusionmodels_tpu import shakespeare as jax_cli
    from tinydiffusionmodels_tpu.io import load_checkpoint

    monkeypatch.setenv("TDM_DATA_LIMIT", "3000")
    (workdir / "empty").mkdir()
    common = ["--model_id", "char", "--data_root", "empty", "--seq_len", "16",
              "--ckpt", "w.pth", "--embed_dim", "48"]
    z = port_cli.main([
        "--train", "--sample", *common, "--epochs", "1", "--batch_size", "8",
        "--depth", "1", "--warmup_steps", "5", "--n", "2", "--sampler",
        "ddim", "--steps", "3",
    ])
    assert tuple(z.shape) == (2, 16, 48) and torch.isfinite(z).all()
    emb = load_checkpoint("w.pth")["embedding_fn"]["embeddings.weight"]
    assert np.asarray(emb).shape[-1] == 48
    sample = ["--sample", "--model_id", "char", "--data_root", "empty",
              "--seq_len", "16", "--ckpt", "w.pth", "--n", "2", "--sampler",
              "ddim", "--steps", "3"]
    (workdir / "samples" / "sample_0.txt").unlink()
    jax_cli.main(sample)
    assert (workdir / "samples" / "sample_0.txt").exists()


def test_no_cuda_without_cpu_opt_in_fails(workdir, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU, so cuda is a valid default")
    monkeypatch.delenv("TDM_PLATFORM")
    _write_jax_checkpoint(workdir / "ckpt.pth")
    with pytest.raises(RuntimeError, match="TDM_PLATFORM=cpu"):
        port_cli.main([*SAMPLE, "--ckpt", "ckpt.pth"])


def test_port_never_imports_jax(workdir):
    """Every module of the package imports, and the CLI samples, in a
    process where ``import jax`` fails."""
    _write_jax_checkpoint(workdir / "ckpt.pth")
    modules = sorted(
        m.name for m in pkgutil.walk_packages(
            tinydiffusionmodels_torch.__path__, "tinydiffusionmodels_torch.")
    )
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from tinydiffusionmodels_torch.shakespeare import main\n"
        f"z = main({[*SAMPLE, '--ckpt', 'ckpt.pth', '--sampler', 'ddim', '--steps', '2']!r})\n"
        "assert tuple(z.shape) == (2, 8, 32)\n"
        "loaded = [m for m, v in sys.modules.items()\n"
        "          if v is not None and (m == 'jax' or m.startswith(('jax.', 'jaxlib')))]\n"
        "assert not loaded, loaded\n"
        "print('NO_JAX_OK')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "TDM_PLATFORM": "cpu",
           "PYTHONPATH": str(REPO), "HOME": str(workdir)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=workdir,
                          capture_output=True, text=True, timeout=180,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert (workdir / "samples" / "sample_0.txt").exists()


def test_sources_name_no_jax():
    pkg = REPO / "tinydiffusionmodels_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), (
                f"{path}: {line}"
            )


GUIDED = ["--guided_sample", "--base_lm", "tinygpt", "--lm_epochs", "1",
          "--model_id", "char", "--n", "2", "--sampler", "ddim", "--steps",
          "3"]


def test_train_then_guided_sample(workdir, capsys):
    """``--train`` then ``--guided_sample --base_lm tinygpt`` on the CPU:
    the first call trains TinyGPT and writes lm_ckpt.pth and the guided
    samples; the second loads lm_ckpt.pth and decodes the same tokens;
    ``--sample --guided_sample`` returns both results, the guided decode
    the same as alone (its draw depends on --seed only)."""
    common = ["--data_root", "data", "--seq_len", "16", "--ckpt", "t.pth"]
    port_cli.main(["--train", "--model_id", "char", "--epochs", "1",
                   "--batch_size", "4", "--embed_dim", "32", "--depth", "1",
                   "--warmup_steps", "2", *common])
    capsys.readouterr()
    tokens = port_cli.main([*GUIDED, *common])
    out = capsys.readouterr().out
    assert "[lm] training TinyGPT base LM for 1 epochs" in out
    assert tokens.dtype == torch.int32 and tuple(tokens.shape) == (2, 16)
    assert (workdir / "lm_ckpt.pth").exists()
    for i in range(2):
        assert (workdir / "samples" / f"guided_sample_{i}.txt").exists()
    again = port_cli.main([*GUIDED, *common])
    out = capsys.readouterr().out
    assert "[lm] loaded TinyGPT from lm_ckpt.pth" in out
    assert "[lm] training" not in out
    torch.testing.assert_close(again, tokens, rtol=0, atol=0)
    z, both = port_cli.main(["--sample", *GUIDED, *common])
    assert tuple(z.shape) == (2, 16, 32)
    torch.testing.assert_close(both, tokens, rtol=0, atol=0)


def test_lm_ckpt_crosses_packages(workdir, capsys):
    """An lm_ckpt.pth the JAX package wrote loads in the port's CLI, and
    one the port wrote loads in the JAX CLI; the weights carry over
    (logits within 1e-5)."""
    from tinydiffusionmodels_tpu import shakespeare as jax_cli
    from tinydiffusionmodels_tpu.io import load_checkpoint
    from tinydiffusionmodels_tpu.io.checkpoint import tree_to_numpy
    from tinydiffusionmodels_tpu.models import init_tiny_gpt, tiny_gpt_apply
    from tinydiffusionmodels_tpu.models.ar_lm import (
        TinyGPTConfig as JaxGPTConfig,
    )
    from tinydiffusionmodels_torch.io import tiny_gpt_params_dict
    from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig

    _write_jax_checkpoint(workdir / "ckpt.pth")
    vocab = CharTokenizer(CORPUS).vocab_size
    kw = dict(vocab_size=vocab, dim=256, n_heads=4, depth=4, max_len=64)
    save_checkpoint({"params": tree_to_numpy(
        init_tiny_gpt(jax.random.PRNGKey(3), JaxGPTConfig(**kw)))},
        "jax_lm.pth")
    common = ["--data_root", "data", "--seq_len", "8", "--ckpt", "ckpt.pth",
              "--use_learned_embeddings"]
    port_cli.main([*GUIDED, *common, "--lm_ckpt", "jax_lm.pth"])
    out = capsys.readouterr().out
    assert "[lm] loaded TinyGPT from jax_lm.pth" in out

    model = TinyGPT(TinyGPTConfig(**kw),
                    generator=torch.Generator().manual_seed(4))
    save_checkpoint({"params": tiny_gpt_params_dict(model)}, "port_lm.pth")
    jax_cli.main([*GUIDED, *common, "--lm_ckpt", "port_lm.pth"])
    out = capsys.readouterr().out
    assert "[lm] loaded TinyGPT from port_lm.pth" in out
    assert (workdir / "samples" / "guided_sample_1.txt").exists()
    ids = np.random.default_rng(0).integers(0, vocab, (2, 8))
    want = tiny_gpt_apply(load_checkpoint("port_lm.pth")["params"],
                          jax.numpy.asarray(ids), JaxGPTConfig(**kw))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_guided_sample_stale_lm_ckpt_retrains(workdir, monkeypatch, capsys):
    """A cached base LM trained under another tokenizer (char vs bpe:96) is
    rejected and retrained, not fed to the mix (the JAX CLI's round-4
    regression, tests/test_cli.py)."""
    monkeypatch.setenv("TDM_DATA_LIMIT", "4000")
    (workdir / "empty").mkdir()
    common = ["--seq_len", "16", "--embed_dim", "32", "--batch_size", "8",
              "--depth", "1", "--data_root", "empty"]
    train = ["--train", "--epochs", "1", "--warmup_steps", "2", *common]
    port_cli.main([*train, "--model_id", "char", "--ckpt", "char_ckpt.pth"])
    port_cli.main([*GUIDED, *common, "--ckpt", "char_ckpt.pth"])
    assert (workdir / "lm_ckpt.pth").exists()
    port_cli.main([*train, "--model_id", "bpe:96", "--ckpt", "bpe_ckpt.pth"])
    capsys.readouterr()
    # --model_id char: the CLI starts from the char tokenizer, re-syncs to
    # the checkpoint's BPE-96 one, and must reject the char-vocab LM.
    port_cli.main([*GUIDED, *common, "--ckpt", "bpe_ckpt.pth"])
    out = capsys.readouterr().out
    assert "[ckpt] vocab_size=96" in out
    assert "could not load lm_ckpt.pth" in out
    assert "[lm] training TinyGPT" in out
    assert (workdir / "samples" / "guided_sample_0.txt").exists()


def _write_mnist_idx(root, n=96):
    """Train IDX files of ``n`` synthetic digits under ``root`` (the first
    place load_mnist looks), so no 60 000-digit render is needed."""
    import struct

    from tinydiffusionmodels_torch.data.mnist import _synthetic_mnist

    images, labels = _synthetic_mnist(n, seed=0)
    root.mkdir(parents=True, exist_ok=True)
    for name, array in (("train-images-idx3-ubyte", images),
                        ("train-labels-idx1-ubyte", labels)):
        (root / name).write_bytes(
            struct.pack(">I", 0x0800 | array.ndim)
            + struct.pack(f">{array.ndim}I", *array.shape)
            + array.astype(np.uint8).tobytes())


def test_mnist_train_then_sample(workdir, monkeypatch):
    """``mnist --train`` on a small dataset (TDM_DATA_LIMIT) with an EMA and
    metrics writes the bare state-dict checkpoint, which the JAX package
    reads; ``--sample --sampler ddim --steps 5`` from it writes
    samples.png."""
    import json

    from tinydiffusionmodels_tpu.io import load_checkpoint
    from tinydiffusionmodels_tpu.io.checkpoint import unet_from_state_dict
    from tinydiffusionmodels_torch import mnist as port_mnist

    _write_mnist_idx(workdir / "digits")
    monkeypatch.setenv("TDM_DATA_LIMIT", "64")
    result = port_mnist.main([
        "--train", "--epochs", "1", "--batch_size", "16", "--ckpt", "m.pth",
        "--data_root", "digits", "--no_epoch_samples", "--ema_decay", "0.9",
        "--metrics_path", "m.jsonl",
    ])
    assert result.steps == 4 and result.step_losses.shape == (4,)
    assert np.isfinite(result.step_losses).all()
    record = json.loads((workdir / "m.jsonl").read_text())
    assert record["workload"] == "mnist" and record["steps"] == 4
    sd = load_checkpoint("m.pth")
    assert list(sd)[:2] == ["rb1.conv1.weight", "rb1.conv1.bias"]
    assert "rb3.skip.weight" not in sd
    unet_from_state_dict(sd)  # the JAX package's reader takes it
    for key, value in result.model.state_dict().items():
        np.testing.assert_array_equal(sd[key], value.numpy())
    assert not (workdir / "samples").exists()

    x = port_mnist.main(["--sample", "--ckpt", "m.pth", "--sampler", "ddim",
                         "--steps", "5"])
    assert tuple(x.shape) == (25, 28, 28, 1) and torch.isfinite(x).all()
    png = (workdir / "samples" / "samples.png").read_bytes()
    assert png.startswith(b"\x89PNG")


def test_mnist_samples_jax_checkpoint(workdir):
    """The port's ``--sample`` reads a checkpoint the JAX package wrote and
    draws the same digits as the UNet loaded from it."""
    from tinydiffusionmodels_tpu.io.checkpoint import unet_to_state_dict
    from tinydiffusionmodels_tpu.models import init_unet
    from tinydiffusionmodels_torch import mnist as port_mnist
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.train import mnist_train

    save_checkpoint(unet_to_state_dict(init_unet(jax.random.PRNGKey(1))),
                    "jax.pth")
    x = port_mnist.main(["--sample", "--ckpt", "jax.pth", "--sampler",
                         "dpm++", "--steps", "2", "--seed", "2"])
    want = mnist_train.sample_images(
        mnist_train.load_unet("jax.pth", "cpu"), make_schedule(),
        method="dpm++", num_steps=2,
        generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(x, want, rtol=0, atol=0)
    assert (workdir / "samples" / "samples.png").exists()


def test_mnist_train_bf16_writes_f32_checkpoint(workdir, monkeypatch):
    """``mnist --train --dtype bf16``: one tiny epoch in bf16 on the CPU
    writes an f32 checkpoint that the port's ``--sample`` loads strict."""
    from tinydiffusionmodels_tpu.io import load_checkpoint
    from tinydiffusionmodels_torch import mnist as port_mnist

    _write_mnist_idx(workdir / "digits")
    monkeypatch.setenv("TDM_DATA_LIMIT", "32")
    result = port_mnist.main([
        "--train", "--dtype", "bf16", "--epochs", "1", "--batch_size", "16",
        "--ckpt", "m.pth", "--data_root", "digits", "--no_epoch_samples",
    ])
    assert result.steps == 2 and np.isfinite(result.step_losses).all()
    sd = load_checkpoint("m.pth")
    assert all(np.asarray(v).dtype == np.float32 for v in sd.values())
    for key, value in result.model.state_dict().items():
        np.testing.assert_array_equal(sd[key], value.numpy())
    x = port_mnist.main(["--sample", "--ckpt", "m.pth", "--sampler", "ddim",
                         "--steps", "2"])
    assert tuple(x.shape) == (25, 28, 28, 1) and torch.isfinite(x).all()


@pytest.mark.parametrize("argv", [
    pytest.param(["--train", "--resume"], id="--resume"),
])
def test_mnist_unported_modes_exit_nonzero(workdir, argv):
    from tinydiffusionmodels_torch import mnist as port_mnist

    with pytest.raises(SystemExit, match="not yet ported to the torch package"):
        port_mnist.main([*argv, "--ckpt", "m.pth"])


def test_profile_dir_traces_the_mnist_cli(workdir):
    """``mnist --sample --profile_dir`` writes trace.json and ops.txt (the
    residual block's plain convolutions among the ops on the CPU) and
    draws what the unprofiled call draws."""
    from tinydiffusionmodels_tpu.io.checkpoint import unet_to_state_dict
    from tinydiffusionmodels_tpu.models import init_unet
    from tinydiffusionmodels_torch import mnist as port_mnist

    save_checkpoint(unet_to_state_dict(init_unet(jax.random.PRNGKey(1))),
                    "jax.pth")
    argv = ["--sample", "--ckpt", "jax.pth", "--sampler", "ddim", "--steps",
            "2"]
    x = port_mnist.main([*argv, "--profile_dir", "prof"])
    _assert_profile(workdir / "prof", "aten::conv")
    torch.testing.assert_close(x, port_mnist.main(argv), rtol=0, atol=0)


def test_profile_trace_without_a_directory_profiles_nothing(tmp_path,
                                                            monkeypatch):
    """``runtime.profile_trace(None)`` runs the block and writes nothing."""
    from tinydiffusionmodels_torch.runtime import profile_trace

    monkeypatch.chdir(tmp_path)
    ran = []
    with profile_trace(None):
        ran.append(1)
    with profile_trace(""):
        ran.append(2)
    assert ran == [1, 2] and not list(tmp_path.iterdir())


def test_mnist_no_cuda_without_cpu_opt_in_fails(workdir, monkeypatch, capsys):
    from tinydiffusionmodels_torch import mnist as port_mnist

    assert port_mnist.main([]) is None
    assert "Nothing to do" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU, so cuda is a valid default")
    monkeypatch.delenv("TDM_PLATFORM")
    with pytest.raises(RuntimeError, match="TDM_PLATFORM=cpu"):
        port_mnist.main(["--sample", "--ckpt", "m.pth"])
