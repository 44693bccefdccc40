"""The per-op table tool (``tinydiffusionmodels_torch.xprof_ops``) on the
CPU at tiny sizes: its categories of a fixed list of kernel names (as the
card's profiler names them), and its table, coverage line and ``XPROF``
record for every step it measures, run eagerly with the plain versions.
The card's coverage (kernels recorded against the graph's kernel nodes,
profiled device time against CUDA events) is checked by ``chip_smoke.py``.
"""

from __future__ import annotations

import json

import pytest

from tinydiffusionmodels_torch import xprof_ops

# Kernel names from torch.profiler tables of the port's steps on the H100.
NAMES = {
    "void (anonymous namespace)::flash_fwd_kernel<float, 64, 4, false>(("
    "anonymous namespace)::Params)": "flash fwd",
    "void (anonymous namespace)::flash_bwd_dq_kernel<float, 64, 1, false>("
    "flash_bwd::BwdParams)": "flash dq",
    "void (anonymous namespace)::flash_bwd_dkv_kernel<__nv_bfloat16, 64, 1,"
    " false>(flash_bwd::BwdParams)": "flash dkv",
    "void (anonymous namespace)::flash_wide_fwd_kernel<float, 1>((anonymous"
    " namespace)::Params, int, int)": "flash fwd",
    "void (anonymous namespace)::flash_wide_dkv_kernel<__nv_bfloat16, 2>("
    "flash_bwd::BwdParams, int, int)": "flash dkv",
    "void (anonymous namespace)::flash_bwd_dq_kernel<float, 256, 2>("
    "flash_bwd::BwdParams)": "flash dq",
    "void (anonymous namespace)::flash_wide_dq_kernel<float, 1>("
    "flash_bwd::BwdParams, int, int)": "flash dq",
    "void (anonymous namespace)::fused_resblock_kernel_narrow<float, 32, fa"
    "lse>((anonymous namespace)::Params)": "resblock",
    "void (anonymous namespace)::fused_resblock_kernel<__nv_bfloat16, 256>(("
    "anonymous namespace)::Params)": "resblock",
    "void (anonymous namespace)::guided_decode_kernel(Params)": "decode",
    "void (anonymous namespace)::single_block_fwd_kernel<float, 64>(P)":
        "single-block attention",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_warpsize"
    "1x4x1_ffma_aligna4_alignc4_execute_kernel": "gemm f32 ffma",
    "sgemm_largek_lds64": "gemm f32 ffma",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>(cut"
    "lass_80_simt_sgemm_128x32_8x5_nn_align1::Params)": "gemm f32 ffma",
    "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNN": "gemm bf16 tensor",
    "std::enable_if<true, void>::type internal::gemvx::kernel<int, int, "
    "float, float, float, float>": "gemm f32 gemv",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float>":
        "gemm split-K reduce",
    "void cublasLt::epilogue::impl::globalKernel<8, 32, float, float>":
        "gemm epilogue",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tile"
    "size256x64x32_warpgroupsize1x1x1": "conv fprop bf16",
    "sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesiz"
    "e32x32x8": "conv dgrad f32",
    "sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize32x128x32": "conv wgrad bf16",
    "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize64x32x8": "conv fft f32",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float, float>":
        "conv layout transpose",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)":
        "collective",
    "Memcpy DtoH (Device -> Pinned)": "copy (memcpy)",
    "Memset (Device)": "memset",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<"
    "float, float, false>": "norm",
    "void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernelTe"
    "mplate<c10::BFloat16>": "norm",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForwardReg<float,"
    " float>": "softmax",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at:"
    ":native::(anonymous namespace)::TensorListMetadata<4>>": (
        "multi-tensor (optimizer, EMA)"),
    "void at::native::(anonymous namespace)::distribution_elementwise_grid"
    "_stride_kernel<float, 4>": "rng",
    "void at::native::(anonymous namespace)::indexSelectSmallIndex<float, "
    "long, unsigned int, 2>": "index",
    "void at::native::index_elementwise_kernel<128, 4>": "index",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
    "kernel_cuda(at::TensorIteratorBase&)>": "copy",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>":
        "copy",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::MeanOps<float>>>": "reduction",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul>>": "elementwise",
    "aten::addmm": "gemm (cpu op)",
    "aten::native_layer_norm": "norm",
    "aten::copy_": "copy",
    "something_new_kernel": "other",
}

# Tiny shapes for the bench's builders on the CPU.
TINY = {"text": dict(batch_size=2, seq_len=8, dim=16, depth=1, vocab=11),
        "mnist": dict(batch_size=2),
        "text_sampler": dict(n=2, seq_len=8, dim=16, depth=1, timesteps=20),
        "mnist_sampler": dict(n_samples=2, timesteps=20),
        "guided": dict(n=2, seq_len=8, vocab=11, dim=16, depth=1)}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_category_of_a_kernel_name(name):
    assert xprof_ops.category(name) == NAMES[name]


def test_step_selection():
    makers = xprof_ops.steps_by_name([512, 2048], 20)
    assert list(makers) == [
        "text_f32_bs8", "text_bf16_bs512", "mnist_f32_bs128",
        "mnist_bf16_bs512", "mnist_bf16_bs2048", "text_sampler_n8",
        "mnist_sampler_n256", "guided_bs8"]
    assert list(xprof_ops.select(makers, ["mnist_bf16", "guided"])) == [
        "mnist_bf16_bs512", "mnist_bf16_bs2048", "guided_bs8"]
    with pytest.raises(ValueError, match="no step"):
        xprof_ops.select(makers, ["nonexistent"])


def test_tables_and_coverage_on_the_cpu(monkeypatch):
    """Every step, built by the bench's builders at tiny sizes on the CPU:
    a coverage line that says there is no graph and the timer is the host
    clock, a category table whose shares sum to 1, and a matching
    ``XPROF`` record."""
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    lines = []
    records = xprof_ops.run(shapes=TINY, batches=[2, 4], replays=2, top=3,
                            log=lines.append)
    names = [r["step"] for r in records]
    assert names == ["text_f32_bs2", "text_bf16_bs2", "mnist_f32_bs2",
                     "mnist_bf16_bs2", "mnist_bf16_bs4", "text_sampler_n2",
                     "mnist_sampler_n2", "guided_bs2"]
    text = "\n".join(lines)
    for rec in records:
        name = rec["step"]
        assert rec["platform"] == "cpu" and rec["timer"] == "host clock"
        assert rec["graph_kernel_nodes"] is None
        assert rec["replay_launches"] is None
        assert rec["profiled_us"] > 0 and rec["timer_us"] > 0
        assert rec["recorded_kernels"] > 0
        shares = sum(c["us"] for c in rec["categories"].values())
        assert shares == pytest.approx(rec["profiled_us"], rel=1e-6)
        assert f"coverage {name}: the profiler recorded" in text
        assert ("XPROF " + json.dumps(rec)) in lines
    assert records[-1]["unit"] == "position"
    assert "no CUDA graph on the CPU" in text
    assert "gemm (cpu op)" in records[0]["categories"]


def test_a_kept_graph_is_instantiated_and_counted(monkeypatch):
    """``graphs.Step.keep_graph`` on one step: its capture asks torch to
    keep the cudaGraph_t, instantiates it, and ``kernel_nodes`` reads that
    graph (a stand-in for torch.cuda's graph API and for libcuda)."""
    import contextlib
    import types

    torch = pytest.importorskip("torch")
    from tinydiffusionmodels_torch import graphs

    made = []

    class Graph:
        def __init__(self, **kw):
            self.kw, self.instantiated, self.replays = kw, False, 0
            made.append(self)

        def register_generator_state(self, gen):
            pass

        def capture_begin(self):
            pass

        def capture_end(self):
            pass

        def instantiate(self):
            self.instantiated = True

        def raw_cuda_graph(self):
            return 1234

        def replay(self):
            self.replays += 1

    def stream(device=None):
        return types.SimpleNamespace(wait_stream=lambda other: None)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "Stream", stream)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "kernel_nodes", lambda raw: raw + 1)
    step = graphs.Step(lambda: None, "cuda", warmup=0)
    with pytest.raises(RuntimeError, match="no kept graph"):
        step.kernel_nodes()
    step.keep_graph = True
    step()
    step()
    assert len(made) == 1 and made[0].kw == {"keep_graph": True}
    assert made[0].instantiated and made[0].replays == 2
    assert step.kernel_nodes() == 1235
    plain = graphs.Step(lambda: None, "cuda", warmup=0)
    plain()
    assert made[1].kw == {} and not made[1].instantiated
