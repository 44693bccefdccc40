"""The torch package's boundary with the JAX package.

The port imports nothing of jax and nothing of ``tinydiffusionmodels_tpu``:
it keeps its own copies of the jax-free modules it needs (the corpus loader
and tokenizers, the MNIST loader, batching, checkpoint storage, the PNG grid
writer, ``.env`` loading, the CLIs' argument parsers). Here those copies are held against the originals on the
same inputs, and a checkpoint written by either package is read by the
other. Everything is exact: the copies are the same code.
"""

import pkgutil
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tinydiffusionmodels_tpu import mnist as jax_mnist_cli  # noqa: E402
from tinydiffusionmodels_tpu import shakespeare as jax_cli  # noqa: E402
from tinydiffusionmodels_tpu.data import loader as jax_loader  # noqa: E402
from tinydiffusionmodels_tpu.data import mnist as jax_mnist  # noqa: E402
from tinydiffusionmodels_tpu.data import shakespeare as jax_corpus  # noqa: E402
from tinydiffusionmodels_tpu.data import tokenizer as jax_tok  # noqa: E402
from tinydiffusionmodels_tpu.io import images as jax_images  # noqa: E402
from tinydiffusionmodels_tpu.io import storage as jax_storage  # noqa: E402
import tinydiffusionmodels_torch  # noqa: E402
from tinydiffusionmodels_torch import mnist as port_mnist_cli  # noqa: E402
from tinydiffusionmodels_torch import shakespeare as port_cli  # noqa: E402
from tinydiffusionmodels_torch.data import loader as port_loader  # noqa: E402
from tinydiffusionmodels_torch.data import mnist as port_mnist  # noqa: E402
from tinydiffusionmodels_torch.data import shakespeare as port_corpus  # noqa: E402
from tinydiffusionmodels_torch.data import tokenizer as port_tok  # noqa: E402
from tinydiffusionmodels_torch.io import images as port_images  # noqa: E402
from tinydiffusionmodels_torch.io import storage as port_storage  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "tinydiffusionmodels_tpu")


def _port_modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages(
            tinydiffusionmodels_torch.__path__, "tinydiffusionmodels_torch.")
    )


def test_port_and_chip_smoke_import_no_jax_package(tmp_path):
    """A fresh process in which jax and the JAX package cannot be imported
    imports every module of the port and ``chip_smoke``, and none of the
    forbidden modules ends up in ``sys.modules``."""
    code = (
        "import importlib, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "loaded = sorted(m for m, v in sys.modules.items() if v is not None\n"
        f"                and m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not loaded, loaded\n"
        "print('PACKAGE_BOUNDARY_OK')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path), "TDM_PLATFORM": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=180,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PACKAGE_BOUNDARY_OK" in proc.stdout


def test_no_import_statement_names_the_jax_package():
    files = [*sorted((REPO / "tinydiffusionmodels_torch").rglob("*.py")),
             REPO / "chip_smoke.py"]
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in FORBIDDEN, f"{path}: {line}"


def test_builtin_corpus_is_the_same(tmp_path):
    assert port_corpus._FALLBACK_PASSAGES == jax_corpus._FALLBACK_PASSAGES
    port = port_corpus.load_text_corpus(tmp_path, min_chars=50_000)
    ref = jax_corpus.load_text_corpus(tmp_path, min_chars=50_000)
    assert port == ref
    assert port[1] == "builtin"


def test_corpus_file_is_read_the_same(tmp_path):
    (tmp_path / "input.txt").write_text("First Citizen:\nBefore we proceed")
    assert (port_corpus.load_text_corpus(tmp_path)
            == jax_corpus.load_text_corpus(tmp_path)
            == ("First Citizen:\nBefore we proceed", "file"))


CORPUS = port_corpus._fallback_corpus(6_000)[:6_000]


def test_char_tokenizer_ids_and_state():
    port, ref = port_tok.CharTokenizer(CORPUS), jax_tok.CharTokenizer(CORPUS)
    text = CORPUS[1000:1400]
    np.testing.assert_array_equal(port.encode(text), ref.encode(text))
    assert port.decode(ref.encode(text)) == ref.decode(ref.encode(text)) == text
    assert port.state() == ref.state()
    back = jax_tok.tokenizer_from_state(port.state())
    np.testing.assert_array_equal(back.encode(text), port.encode(text))


def test_bpe_tokenizer_ids_and_state():
    vocab = port_tok.parse_bpe_spec("bpe:160")
    assert vocab == jax_tok.parse_bpe_spec("bpe:160")
    port = port_tok.BPETokenizer.train(CORPUS, vocab)
    ref = jax_tok.BPETokenizer.train(CORPUS, vocab)
    assert port.state() == ref.state()
    text = CORPUS[2000:2600]
    np.testing.assert_array_equal(port.encode(text), ref.encode(text))
    assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))
    again = port_tok.tokenizer_from_state(ref.state())
    np.testing.assert_array_equal(again.encode(text), ref.encode(text))


def test_chunks_split_and_batch_order():
    tok = port_tok.CharTokenizer(CORPUS)
    port = port_loader.tokenize_corpus(CORPUS, tok, 32, 0.1)
    ref = jax_loader.tokenize_corpus(CORPUS, tok, 32, 0.1)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    train = port[0]
    for epoch in (0, 3):
        for a, b in zip(
            port_loader.batch_iterator(train, 8, seed=5, epoch=epoch),
            jax_loader.batch_iterator(train, 8, seed=5, epoch=epoch),
        ):
            np.testing.assert_array_equal(a, b)
    assert (port_loader.num_batches(len(train), 8)
            == jax_loader.num_batches(len(train), 8))


@pytest.mark.parametrize("argv", [
    [],
    ["--train", "--epochs", "3", "--batch_size", "8", "--pos_emb",
     "--embed_norm", "zscore", "--ema_decay", "0.999", "--seq_parallel"],
    ["--sample", "--sampler", "dpm++", "--steps", "20", "--clamp",
     "--parameterization", "x0", "--model_id", "bpe:300", "--dtype", "bf16"],
])
def test_cli_parser_is_the_same(argv):
    port = vars(port_cli.build_parser().parse_args(argv))
    ref = vars(jax_cli.build_parser().parse_args(argv))
    assert port == ref


def test_cli_parser_flags_are_the_same():
    def flags(parser):
        return {
            a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs,
                     a.const, a.type)
            for a in parser._actions
        }

    assert flags(port_cli.build_parser()) == flags(jax_cli.build_parser())


def _tree():
    return {
        "diffusion_model": OrderedDict([
            ("time_emb.weight", np.arange(6, dtype=np.float32).reshape(3, 2)),
            ("encoder.layers.0.norm1.bias", np.zeros(3, np.float32)),
        ]),
        "rounding_fn": {"decoder.weight": np.full((4, 3), 0.5, np.float32)},
        "opt_state_leaves": [np.arange(5, dtype=np.int64),
                             np.ones((2, 2), np.float32)],
        "tokenizer": {"kind": "char", "chars": ["a", "b", "\n"]},
        "epoch": 3,
        "val_loss": 1.25,
        "parameterization": "eps",
        "self_cond": False,
        "final_training": True,
    }


def _assert_same(got, want, where="ckpt"):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for key in want:
            _assert_same(got[key], want[key], f"{where}[{key!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want and type(got) is type(want), where


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jax_storage.save_checkpoint(_tree(), tmp_path / "jax.pth")
    _assert_same(port_storage.load_checkpoint(tmp_path / "jax.pth"), _tree())


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    port_storage.save_checkpoint(_tree(), tmp_path / "port.pth")
    _assert_same(jax_storage.load_checkpoint(tmp_path / "port.pth"), _tree())
    # And the port reads back what it wrote.
    _assert_same(port_storage.load_checkpoint(tmp_path / "port.pth"), _tree())


def test_storage_paths_are_the_same(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for env in (None, "gs://bucket/run/model"):
        if env is None:
            monkeypatch.delenv("AIP_MODEL_DIR", raising=False)
        else:
            monkeypatch.setenv("AIP_MODEL_DIR", env)
        assert (port_storage.get_vertex_checkpoint_path("text-model.pth")
                == jax_storage.get_vertex_checkpoint_path("text-model.pth"))
        assert (str(port_storage.get_samples_dir())
                == str(jax_storage.get_samples_dir()))


@pytest.mark.parametrize("n, seed", [(120, 0), (40, 1)])
def test_synthetic_digits_are_the_same(n, seed):
    port = port_mnist._synthetic_mnist(n, seed=seed)
    ref = jax_mnist._synthetic_mnist(n, seed=seed)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port_mnist._SYNTH_RENDERER_VERSION == jax_mnist._SYNTH_RENDERER_VERSION


def _write_idx(path, array):
    """An IDX file of uint8 data (magic 0x08, then the dims, big-endian)."""
    import gzip
    import struct

    payload = (struct.pack(">I", 0x0800 | array.ndim)
               + struct.pack(f">{array.ndim}I", *array.shape)
               + array.astype(np.uint8).tobytes())
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".gz":
        path.write_bytes(gzip.compress(payload))
    else:
        path.write_bytes(payload)


@pytest.mark.parametrize("layout", ["raw", "gz", "torchvision_gz"])
def test_idx_files_are_read_the_same(tmp_path, layout):
    images, labels = port_mnist._synthetic_mnist(30, seed=4)
    root = tmp_path / "mnist"
    sub = root / "MNIST" / "raw" if layout == "torchvision_gz" else root
    ext = "" if layout == "raw" else ".gz"
    _write_idx(sub / f"train-images-idx3-ubyte{ext}", images)
    _write_idx(sub / f"train-labels-idx1-ubyte{ext}", labels)
    port = port_mnist.load_mnist(root, train=True)
    ref = jax_mnist.load_mnist(root, train=True)
    assert port[2] == ref[2] == "idx"
    for a, b in zip(port[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port[0], images)


def test_synthetic_cache_is_shared(tmp_path):
    """Both loaders fall through to the synthetic digits and read each
    other's versioned .npz cache."""
    port = port_mnist.load_mnist(tmp_path, synthetic_size=24)
    assert port[2] == "synthetic"
    assert (tmp_path / "synthetic_mnist_v1_24_0.npz").exists()
    ref = jax_mnist.load_mnist(tmp_path, synthetic_size=24)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    test_split = jax_mnist.load_mnist(tmp_path, train=False, synthetic_size=24)
    again = port_mnist.load_mnist(tmp_path, train=False, synthetic_size=24)
    np.testing.assert_array_equal(again[0], test_split[0])


def test_normalize_mnist_is_the_same():
    images = np.arange(0, 256 * 4, dtype=np.int64).reshape(4, 16, 16) % 256
    images = images.astype(np.uint8)
    port = port_mnist.normalize_mnist(images)
    ref = jax_mnist.normalize_mnist(images)
    assert port.shape == (4, 16, 16, 1) and port.dtype == ref.dtype
    np.testing.assert_array_equal(port, ref)


def test_png_grid_bytes_are_the_same():
    rng = np.random.default_rng(0)
    images = rng.uniform(-0.2, 1.2, (7, 28, 28)).astype(np.float32)
    assert port_images.grid_png(images, 3) == jax_images.grid_png(images, 3)
    np.testing.assert_array_equal(port_images.make_grid(images, 4),
                                  jax_images.make_grid(images, 4))
    gray = (rng.uniform(0, 1, (5, 9)) * 255).astype(np.uint8)
    assert port_images.encode_png_gray(gray) == jax_images.encode_png_gray(gray)


@pytest.mark.parametrize("argv", [
    [],
    ["--train", "--epochs", "1", "--batch_size", "64", "--ema_decay", "0.999",
     "--no_epoch_samples", "--metrics_path", "m.jsonl", "--dtype", "bf16"],
    ["--sample", "--sampler", "ddim", "--steps", "50", "--ckpt", "x.pth",
     "--seed", "3", "--resume", "--resume_every", "2"],
])
def test_mnist_cli_parser_is_the_same(argv):
    port = vars(port_mnist_cli.build_parser().parse_args(argv))
    ref = vars(jax_mnist_cli.build_parser().parse_args(argv))
    assert port == ref


def test_mnist_cli_parser_flags_are_the_same(monkeypatch):
    def flags(parser):
        return {
            a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs,
                     a.const, a.type, a.help)
            for a in parser._actions if a.dest != "help"
        }

    assert flags(port_mnist_cli.build_parser()) == flags(
        jax_mnist_cli.build_parser())
    monkeypatch.setenv("AIP_MODEL_DIR", "gs://bucket/run")
    assert (port_mnist_cli.build_parser().parse_args([]).ckpt
            == jax_mnist_cli.build_parser().parse_args([]).ckpt
            == "gs://bucket/run/image-model.pth")
