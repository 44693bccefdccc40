"""MNIST UNet training through the program's chunk runner
(``train/mnist_train.MnistSteps``): the reference's DDPM step, the
eps-prediction MSE of SimpleUNet at uniform timesteps, AdamW, with the
program's own draws of timesteps and noise from the key tree of the seed.

The images (uniform on [-1, 1], the range of normalised MNIST; no MNIST
is on the machine) and the weights are the benchmark's, made on the
device from the seed; the reference makes them again."""

from __future__ import annotations

import math

import torch

from gpubench import weights
from gpubench.builders.training import Training
from gpubench.reference import keytree
from gpubench.reference import unet as ref_unet
from gpubench.reference.diffusion import Schedule, q_sample
from gpubench.work import flops, kernels, peaks

SHAPE = (28, 28, 1)


class UnetTraining(Training):
    loss_columns = [0]

    def __init__(self, cell, seed, device):
        self.timesteps = cell.config["model"]["timesteps"]
        o = cell.config["optimizer"]
        self.lr, self.weight_decay = o["lr"], o["weight_decay"]
        super().__init__(cell, seed, device)
        self.bounds["resblock"] = [("resblock", [
            peaks.bound_s(*w) for w in kernels.unet_resblocks(self.batch)])]

    def step_flops(self) -> int:
        return flops.unet_train_step(self.batch)

    def inputs(self, gen):
        params = weights.draw(weights.unet(ref_unet.BLOCKS), gen, self.device)
        images = torch.rand((self.epoch_steps * self.batch, *SHAPE),
                            generator=gen, device=self.device)
        return params, images.mul_(2.0).sub_(1.0)

    def train_key(self):
        return keytree.substream(keytree.prng_key(self.seed), "train")

    def program(self, params, images):
        from tinydiffusionmodels_torch.core import make_schedule
        from tinydiffusionmodels_torch.models import SimpleUNet
        from tinydiffusionmodels_torch.train import mnist_train
        from tinydiffusionmodels_torch.train.optim import adamw

        model = SimpleUNet(self.timesteps, device="meta").to_empty(
            device=self.device)
        model.load_state_dict(params)
        optimizer = adamw(model.parameters(), self.lr,
                          weight_decay=self.weight_decay)
        steps = mnist_train.MnistSteps(
            model, optimizer, images,
            make_schedule(self.timesteps, device=self.device),
            batch_size=self.batch, steps=self.epoch_steps,
            key=torch.tensor(self.train_key(), dtype=torch.int64))
        return steps, list(model.named_parameters()), optimizer

    def start_kw(self, first_step: int) -> dict:
        return {"first_step": first_step}

    def reference_losses(self, train, params, images, rows, step):
        key = keytree.fold_in(self.train_key(), step)
        x0 = images[rows]
        n = x0.shape[0]
        t = keytree.randint32(keytree.substream(key, "timesteps"),
                              torch.arange(n, device=self.device), 0,
                              self.timesteps)
        shape = (n, *SHAPE)
        noise = keytree.counter_normal(
            keytree.substream(key, "noise"),
            keytree.full_index(shape, self.device), math.prod(shape))
        sched = Schedule(self.timesteps, self.device)
        eps = ref_unet.denoise(train, q_sample(sched, x0, t, noise), t,
                               timesteps=self.timesteps)
        return (torch.mean((eps - noise) ** 2),)


def build(cell, seed, device):
    return UnetTraining(cell, seed, device)
