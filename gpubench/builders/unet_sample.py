"""MNIST sampling: whole 1000-step ancestral batches of SimpleUNet
through the program's ``sample.ancestral.Sampler`` (as ``mnist_train.
sample_images`` runs it), the weights the benchmark's, made on the device
from the seed. A batch's answer is its (n, 28, 28, 1) images, read back to
the host; the check compares picked images' pixels with the reference's
chains."""

from __future__ import annotations

from gpubench import weights
from gpubench.builders.sampling import Sampling, sample_gap
from gpubench.reference import unet as ref_unet
from gpubench.reference.diffusion import Schedule, ancestral_rows
from gpubench.work import flops, kernels, peaks

SHAPE = (28, 28, 1)


class UnetSampling(Sampling):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.bounds["resblock"] = [("resblock", [
            peaks.bound_s(*w) for w in kernels.unet_resblocks(self.n)])]

    def batch_flops(self) -> int:
        return flops.unet_sample_batch(self.n, self.timesteps)

    def specs(self):
        return weights.unet(ref_unet.BLOCKS)

    def program(self, params):
        from tinydiffusionmodels_torch.core import make_schedule
        from tinydiffusionmodels_torch.models import SimpleUNet
        from tinydiffusionmodels_torch.sample.ancestral import Sampler

        model = SimpleUNet(self.timesteps, device="meta").to_empty(
            device=self.device)
        model.load_state_dict(params)
        sampler = Sampler(model.eval(),
                          make_schedule(self.timesteps, device=self.device),
                          (self.n, *SHAPE))
        return sampler, lambda x: {"x": x}

    def reference_rows(self, params, key, rows):
        t = self.timesteps
        x = ancestral_rows(
            lambda x, tb: ref_unet.denoise(params, x, tb, timesteps=t),
            Schedule(t, self.device), (self.n, *SHAPE), key, rows,
            self.device)
        return {"x": x}

    def altered(self, out: dict) -> dict:
        x = out["x"].clone()
        x[:, 0, 0, 0] += 1.0
        return {"x": x}

    def compare(self, prog, ref) -> dict:
        return {"sample_gap": sample_gap(prog, ref)}


def build(cell, seed, device):
    return UnetSampling(cell, seed, device)
