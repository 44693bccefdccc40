"""Text sampling as the CLI's ``--sample`` runs it: whole 1000-step
ancestral batches of (n, length, dim) embeddings from the TinyTransformer
denoiser through the program's ``sample.ancestral.Sampler`` (with
``sample.text.make_denoiser``), then the rounding head's logits and
their argmax (``sample.text.decode_embeddings``). The weights are the
benchmark's, made on the device from the seed. A batch's answers are its
tokens and its final embeddings, read back to the host; the check
compares picked samples' embeddings with the reference's chains, and
their tokens by the widest gap by which a served token's reference logit
lies below the reference's best at that position."""

from __future__ import annotations

import torch

from gpubench import weights
from gpubench.builders.sampling import Sampling, sample_gap
from gpubench.reference import text as ref_text
from gpubench.reference.diffusion import Schedule, ancestral_rows
from gpubench.work import flops, kernels, peaks


class TextSampling(Sampling):
    def __init__(self, cell, seed, device):
        m = cell.config["model"]
        self.dim, self.heads, self.depth = m["dim"], m["heads"], m["depth"]
        self.ffn, self.vocab = m["ffn_dim"], m["vocab_size"]
        self.length = cell.workload["traffic"]["length"]
        super().__init__(cell, seed, device)
        n, dh = self.length, self.dim // self.heads
        self.bounds["flash_wide"] = [("flash_wide_fwd", [peaks.bound_s(
            *kernels.flash("fwd", self.n, self.heads, n, n, dh, dh, 4,
                           dropout=False, lse=False))])]

    def batch_flops(self) -> int:
        return flops.text_sample_batch(self.n, self.length, self.dim,
                                       self.heads, self.depth, self.ffn,
                                       self.vocab, self.timesteps)

    def specs(self):
        return (weights.transformer(self.dim, self.depth, self.ffn)
                + weights.rounding(self.dim, self.vocab))

    def program(self, params):
        from tinydiffusionmodels_torch.core import make_schedule
        from tinydiffusionmodels_torch.models import (
            LearnedRounding,
            TinyTransformer,
            TransformerConfig,
        )
        from tinydiffusionmodels_torch.sample.ancestral import Sampler
        from tinydiffusionmodels_torch.sample.text import (
            decode_embeddings,
            make_denoiser,
        )

        cfg = TransformerConfig(dim=self.dim, n_heads=self.heads,
                                depth=self.depth, ffn_dim=self.ffn,
                                timesteps=self.timesteps)
        model = TinyTransformer(cfg, device="meta").to_empty(
            device=self.device)
        model.load_state_dict({k: v for k, v in params.items()
                               if not k.startswith("decoder.")})
        rounding = LearnedRounding(self.dim, self.vocab,
                                   device="meta").to_empty(device=self.device)
        rounding.load_state_dict({k: v for k, v in params.items()
                                  if k.startswith("decoder.")})
        sched = make_schedule(self.timesteps, device=self.device)
        sampler = Sampler(make_denoiser(model.eval(), sched), sched,
                          (self.n, self.length, self.dim))

        def finish(x):
            tokens = decode_embeddings(x, rounding=rounding.eval(),
                                       embed_matrix=None,
                                       use_learned_rounding=True)
            return {"x": x, "tokens": tokens}

        return sampler, finish

    def reference_rows(self, params, key, rows):
        kw = dict(heads=self.heads, depth=self.depth,
                  timesteps=self.timesteps)
        x = ancestral_rows(
            lambda x, tb: ref_text.denoise(params, x, tb, **kw),
            Schedule(self.timesteps, self.device),
            (self.n, self.length, self.dim), key, rows, self.device)
        logits = ref_text.rounding_logits(params, x)
        return {"x": x, "logits": logits, "tokens": logits.argmax(-1)}

    def altered(self, out: dict) -> dict:
        tokens = out["tokens"].clone()
        tokens[:, 0] = (tokens[:, 0] + 1) % self.vocab
        return {**out, "tokens": tokens}

    def compare(self, prog, ref) -> dict:
        gap = 0.0
        for p, r in zip(prog, ref):
            logits = r["logits"]
            served = torch.gather(logits, -1, p["tokens"][..., None])[..., 0]
            gap = max(gap, float((logits.max(-1).values - served).max()))
        return {"x0_gap": sample_gap(prog, ref), "token_gap": gap}


def build(cell, seed, device):
    return TextSampling(cell, seed, device)
