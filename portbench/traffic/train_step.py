"""Training steps of the port's fused step, back to back.

Set-up makes ``images`` seeded images, cuts ``pool_batches`` batches of
``batch_size`` crops from them (every crop its own) and stages them on the
device, builds the port's U-Net with the seeded weights, the port's
optimizer (``train.make_optimizer``: Adam with L2 decay) and the step
``train.make_train_step_fused`` builds (pairs drawn on the device from a
generator seeded a step), as ``train()`` builds them for this recipe, and
runs the first ``checked_steps`` steps through that same step: they warm
up every shape, and the check compares them. The window goes on stepping
the same object over the pool in turn until ``--seconds`` have passed,
fetching each step's loss one step late as ``train()`` does, and ends with
a synchronize; it reports the window's time over the steps completed in
it. The host loader of ``train()`` is left out: the card paces the step at
this width.

The check runs the reference's first ``checked_steps`` steps from the same
weights on the same batches and pairs, and compares each step's loss, the
first gradient as the optimizer takes it (read back from Adam's first
moment after one step) and the parameters' change over the steps, each by
its worst leaf.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from .. import flops, inputs
from ..reference import judge
from ..reference import train as ref
from ..reference.unet import no_tf32

IMAGES, WEIGHTS, CROPS = 1, 2, 3
BETA1 = 0.9


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir: Path,
                 timings: dict, fault=None):
        from cellulus_tpu_torch.datasets.sampling import PairSampler
        from cellulus_tpu_torch.models import UNet
        from cellulus_tpu_torch.train import make_optimizer, make_train_step_fused

        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.model_cfg, self.train = config["model"], config["train"]
        tc = self.train
        crop = tuple(tc["crop_size"])
        self.ndim = len(crop)
        self.batch = int(tc["batch_size"])
        self.dtype = torch.bfloat16 if tc["precision"] == "bfloat16" else torch.float32
        if self.dtype == torch.float32:
            no_tf32()

        t = time.perf_counter()
        size = tuple(traffic["image_size"])
        images = torch.from_numpy(inputs.nuclei(int(traffic["images"]), size, self.device,
                                                inputs.generator(self.device, self.seed,
                                                                 IMAGES)))
        images = images.to(self.device).float() * (1.0 / 255.0)
        n = int(traffic["pool_batches"]) * self.batch
        gen = inputs.generator(self.device, self.seed, CROPS)
        which = torch.randint(0, images.shape[0], (n,), generator=gen, device=self.device)
        corner = [torch.randint(0, s - c + 1, (n,), generator=gen, device=self.device)
                  for s, c in zip(size, crop)]
        crops = [images[int(which[i])][(slice(None),) + tuple(
            slice(int(o[i]), int(o[i]) + c) for o, c in zip(corner, crop))] for i in range(n)]
        # (P, B, C, *crop): the reference's layout; the program takes channels last
        self.pool = torch.stack(crops).reshape(-1, self.batch, *crops[0].shape)
        self.pool_cl = self.pool.movedim(2, -1).contiguous()
        self.weights = inputs.weights(self.model_cfg, self.ndim, self.device,
                                      inputs.generator(self.device, self.seed, WEIGHTS))
        timings["data_s"] = time.perf_counter() - t

        t = time.perf_counter()
        m = self.model_cfg
        self.model = UNet(m["in_channels"], self.ndim, m["num_fmaps"], m["fmap_inc_factor"],
                          m["features_in_last_layer"], m["downsampling_factors"], self.ndim,
                          m["constant_upsample"])
        self.model.load_state_dict({k: v.clone() for k, v in self.weights.items()})
        self.model.to(self.device)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.optimizer = make_optimizer(self.model.parameters(), tc["initial_learning_rate"],
                                        weight_decay=tc["weight_decay"])
        out_shape = flops.output_size(crop, m["downsampling_factors"])
        sampler = PairSampler(out_shape, tc["density"], tc["kappa"], tc["pair_count_mode"])
        self.step = make_train_step_fused(self.model, self.optimizer, tc["temperature"],
                                          tc["regularizer_weight"], sampler, self.batch,
                                          self.dtype, device=self.device)
        if fault is not None:
            self.step = fault(self.step, self)
        self.generator = torch.Generator(device=self.device)
        self.steps = 0
        # the first steps: the warm-up, and what the check compares
        self.losses = []
        for i in range(int(traffic["checked_steps"])):
            loss, _, _ = self._step()
            self.losses.append(float(loss))
            if i == 0:
                # Adam's first moment after one step is (1 - beta1) times the
                # gradient it took; a leaf it never took reads zero
                state = self.optimizer.adam.state
                self.first = {n: (state[p]["exp_avg"] / (1 - BETA1)).detach().cpu()
                              if p in state else torch.zeros(p.shape)
                              for n, p in zip(self.names, self.optimizer.params)}
        self.after = {n: p.detach().cpu().clone() for n, p in self.model.named_parameters()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings["warmup_s"] = time.perf_counter() - t

    def _step(self):
        self.generator.manual_seed(ref.generator_seed(self.seed, ref.PAIRS, self.steps))
        raw = self.pool_cl[self.steps % self.pool_cl.shape[0]]
        self.steps += 1
        with torch.profiler.record_function("portbench: step"):
            return self.step(raw, self.generator)

    def window(self, seconds: float) -> dict:
        start_steps = self.steps
        losses = []
        t0 = time.perf_counter()
        pending = None
        while True:
            loss, _, _ = self._step()
            if pending is not None:
                losses.append(float(pending))
            pending = loss
            if time.perf_counter() - t0 >= seconds:
                break
        losses.append(float(pending))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        steps = self.steps - start_steps
        return {
            "end_to_end": {"train_step_ms": 1e3 * (t1 - t0) / steps},
            "attempted": steps, "failed": int(sum(not np.isfinite(v) for v in losses)),
            "window_s": t1 - t0, "steps": steps,
        }

    def release(self) -> None:
        del self.model, self.optimizer, self.step
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def judge(self, mode: str = "program") -> dict:
        """The compared numbers. ``mode="control"`` puts the reference in the
        program's place with TF32 on; ``"half"`` and ``"altered"`` put it
        there with that fault planted (``reference.train.run_steps``)."""
        restore = no_tf32()
        try:
            n = len(self.losses)
            batches = [self.pool[i % self.pool.shape[0]] for i in range(n)]
            w0 = {k: v.clone() for k, v in self.weights.items()}
            want = ref.run_steps(w0, self.model_cfg, self.train, batches, self.seed, self.device)
            if mode == "program":
                losses, first, after = self.losses, self.first, self.after
            else:
                if mode == "control":
                    torch.backends.cuda.matmul.allow_tf32 = True
                    torch.backends.cudnn.allow_tf32 = True
                fault = mode if mode in ("half", "altered") else None
                losses, first, after = ref.run_steps(w0, self.model_cfg, self.train, batches,
                                                     self.seed, self.device, fault)
                no_tf32()
            return numbers(losses, first, after, want, self.weights, self.names)
        finally:
            restore()

    def work(self, details: dict) -> dict:
        crop = tuple(self.train["crop_size"])
        return {
            "steps": details["steps"],
            # forward, input gradients and filter gradients: three forwards
            "flops": 3 * details["steps"] * self.batch
            * flops.model_flops(self.model_cfg, crop, self.ndim),
            "k2_shapes": flops.k2_shapes(self.model_cfg, self.batch, crop),
            "dtype": self.dtype,
        }


def numbers(losses, first, after, want, weights, names) -> dict:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap``: the worst leaf's gap of the first gradient's norm;
    ``change_gap``: the worst leaf's gap of the norm of the parameters'
    change over the steps, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's (the others move by rounding
    alone)."""
    want_losses, want_first, want_after = want
    dev = lambda d: {k: v.detach().float().cpu() for k, v in d.items()}  # noqa: E731
    first, want_first, after, want_after = map(dev, (first, want_first, after, want_after))
    w0 = dev(weights)
    change = {n: after[n] - w0[n] for n in names}
    want_change = {n: want_after[n] - w0[n] for n in names}
    g = np.array([float(torch.linalg.vector_norm(want_first[n].double())) for n in names])
    moving = [n for n, v in zip(names, g) if v >= 1e-3 * np.median(g)]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    return {
        "loss_gap": float(loss_gap),
        "grad_gap": judge.leaf_gaps(first, want_first, names),
        "change_gap": judge.leaf_gaps(change, want_change, moving),
        "grad_leaf": judge.worst_leaf(first, want_first, names),
        "change_leaf": judge.worst_leaf(change, want_change, moving),
        "step_loss_gaps": [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)],
    }
