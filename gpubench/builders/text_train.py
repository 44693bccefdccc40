"""Text denoiser training through the program's chunk runner
(``train/text_train.TextSteps``): the reference's default step, the
TinyTransformer denoiser and the LearnedRounding head trained jointly
by AdamW on the eps MSE plus the rounding cross-entropy, the embedding
table frozen (the reference without ``--use_learned_embeddings``), with
the program's own draws: timesteps, noise, every dropout mask and the
flash kernels' attention-dropout seeds from the key tree of the seed.

The tokens (rows of ``length`` ids, uniform over the vocabulary), the
table and the weights are the benchmark's, made on the device from the
seed; the reference makes them again."""

from __future__ import annotations

import torch

from gpubench import weights
from gpubench.builders.training import Training
from gpubench.reference import keytree
from gpubench.reference import text as ref_text
from gpubench.reference.diffusion import Schedule
from gpubench.work import flops, kernels, peaks


class TextTraining(Training):
    loss_columns = [0, 1]    # (diffusion MSE, rounding CE)

    def __init__(self, cell, seed, device):
        m = cell.config["model"]
        self.dim, self.heads, self.depth = m["dim"], m["heads"], m["depth"]
        self.ffn, self.vocab = m["ffn_dim"], m["vocab_size"]
        self.rate, self.timesteps = m["dropout"], m["timesteps"]
        self.table_std = m["table_std"]
        o = cell.config["optimizer"]
        self.lr, self.weight_decay = o["lr"], o["weight_decay"]
        self.rounding_weight = cell.config["loss"]["rounding_weight"]
        self.length = cell.workload["traffic"]["length"]
        super().__init__(cell, seed, device)
        b, h, n = self.batch, self.heads, self.length
        dh = self.dim // h
        self.bounds["flash_wide"] = [
            (f"flash_wide_{k}", [peaks.bound_s(*kernels.flash(
                k, b, h, n, n, dh, dh, 4, dropout=self.rate > 0))])
            for k in ("fwd", "dq", "dkv")]

    def step_flops(self) -> int:
        return flops.text_train_step(self.batch, self.length, self.dim,
                                     self.heads, self.depth, self.ffn,
                                     self.vocab)

    def specs(self):
        return (weights.transformer(self.dim, self.depth, self.ffn,
                                    "diffusion_model.")
                + weights.rounding(self.dim, self.vocab, "rounding_fn.")
                + [("table", (self.vocab, self.dim),
                    ("normal", self.table_std))])

    def inputs(self, gen):
        params = weights.draw(self.specs(), gen, self.device)
        tokens = torch.randint(self.vocab, (self.epoch_steps * self.batch,
                                            self.length),
                               generator=gen, device=self.device)
        return params, tokens

    def train_key(self):
        return keytree.substream(keytree.prng_key(self.seed), "train")

    def program(self, params, tokens):
        from torch import nn

        from tinydiffusionmodels_torch.core import make_schedule
        from tinydiffusionmodels_torch.models import (
            LearnedRounding,
            TinyTransformer,
            TransformerConfig,
        )
        from tinydiffusionmodels_torch.train import text_train
        from tinydiffusionmodels_torch.train.optim import adamw

        cfg = TransformerConfig(dim=self.dim, n_heads=self.heads,
                                depth=self.depth, dropout=self.rate,
                                ffn_dim=self.ffn, timesteps=self.timesteps)
        joint = nn.ModuleDict({
            "diffusion_model": TinyTransformer(cfg, device="meta"),
            "rounding_fn": LearnedRounding(self.dim, self.vocab,
                                           device="meta"),
        }).to_empty(device=self.device)
        joint.load_state_dict({k: v for k, v in params.items()
                               if k != "table"})
        optimizer = adamw(joint.parameters(), self.lr,
                          weight_decay=self.weight_decay)
        steps = text_train.TextSteps(
            joint, optimizer, tokens, batch_size=self.batch,
            steps=self.epoch_steps,
            key=torch.tensor(self.train_key(), dtype=torch.int64),
            sched=make_schedule(self.timesteps, device=self.device),
            use_learned_embeddings=False, pretrained_matrix=params["table"])
        return steps, list(joint.named_parameters()), optimizer

    def start_kw(self, first_step: int) -> dict:
        return {"rounding_weight": self.rounding_weight,
                "first_step": first_step}

    def trainable(self, params):
        return [k for k in params if k != "table"]

    def reference_losses(self, train, params, tokens, rows, step):
        pre = "diffusion_model."
        den = {k[len(pre):]: v for k, v in train.items() if k.startswith(pre)}
        rnd = {k[len("rounding_fn."):]: v for k, v in train.items()
               if k.startswith("rounding_fn.")}
        return ref_text.train_losses(
            den, rnd, params["table"], tokens[rows],
            keytree.fold_in(self.train_key(), step),
            sched=Schedule(self.timesteps, self.device), heads=self.heads,
            depth=self.depth, rate=self.rate,
            rounding_weight=self.rounding_weight)


def build(cell, seed, device):
    return TextTraining(cell, seed, device)
