"""The object-centric-embedding U-Net as an ``nn.Module``, 2D and 3D.

Port of ``cellulus_tpu/models/unet.py:forward``: per level a valid
``[3,1,1,3]`` conv pass, max-pool on the way down; on the way up nearest
upsampling (``constant_upsample=True``) or a learned transposed conv with
kernel = stride = the level's factor, a center crop of the skip by
``(size - target) // 2``, the concat ``[skip, up]`` and a conv pass; then
the head ``1x1 -> ReLU -> 1x1`` with no final activation.

Activations are channels-last (NHWC, NDHWC) throughout. In 2D ``forward``
takes one of two paths, which compute the same function:

- inference (grad mode off, or nothing requires a gradient): every conv
  pass runs through :func:`~cellulus_tpu_torch.ops.conv_pass.conv_pass_2d`
  (kernel K1 on the card), which defines no gradient;
- training: each conv is its own differentiable op, the 3x3 ones
  :class:`~cellulus_tpu_torch.ops.conv_vjp.Conv3x3Valid` (filter gradient
  by kernel K2 on the card), the 1x1 ones channel matmuls. As in the JAX
  package's ``_conv`` (``cellulus_tpu/models/unet.py:199-226``), each conv
  output is in the compute dtype, then ``+ b`` in the compute dtype, then
  ReLU. In float32 the two paths agree to float rounding; in bfloat16 K1
  adds the bias before its one rounding, so they differ by bf16 roundings
  carried through the network.

With ``remat`` set, each conv pass of the training path runs under
``torch.utils.checkpoint``: the backward recomputes its activations.

In 3D there is one path for both, as in the JAX package, which sends no 3D
conv to a Pallas kernel: each conv is ``F.conv3d`` (cuDNN on the card, its
own gradients) in the compute dtype, then ``+ b`` in the compute dtype,
then ReLU. A pass enters the NCDHW view once and leaves it once: the view
of an NDHWC tensor is ``channels_last_3d`` in memory, so nothing is copied.

Parameters are stored in funlib's layout and naming
(``backbone.l_conv.<l>.conv_pass.<2i>``, ``backbone.r_conv.0.<l>.conv_pass.<2i>``,
``backbone.r_up.0.<l>.up`` for the transposed convs, ``head.<0|2>``), so
reference ``.pth`` checkpoints load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.conv_pass import conv_pass_2d
from ..ops.conv_vjp import conv3x3_valid

PASS_KERNELS = (3, 1, 1, 3)
_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_TRANSPOSE = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, *range(2, x.dim()), 1)


class ConvPass(nn.Module):
    def __init__(self, c_in: int, c_out: int, num_spatial_dims: int = 2):
        super().__init__()
        layers = []
        for k in PASS_KERNELS:
            layers += [_CONV[num_spatial_dims](c_in, c_out, k), nn.ReLU()]
            c_in = c_out
        self.conv_pass = nn.Sequential(*layers)
        self.num_spatial_dims = num_spatial_dims

    def pass_params(self) -> dict:
        """The pass's weights as ``(kh, kw, C_in, C_out)`` views."""
        convs = self.conv_pass[::2]
        return {
            f"conv{i}": {"w": conv.weight.permute(2, 3, 1, 0), "b": conv.bias}
            for i, conv in enumerate(convs)
        }

    def forward(self, x: torch.Tensor, compute_dtype, fused: bool) -> torch.Tensor:
        if self.num_spatial_dims == 3:
            return self._forward_3d(x, compute_dtype)
        if fused:
            return conv_pass_2d(x, self.pass_params(), compute_dtype)
        for conv in self.conv_pass[::2]:
            if conv.kernel_size == (3, 3):
                w = conv.weight.to(compute_dtype)
                x = conv3x3_valid(x.to(compute_dtype), w) + conv.bias.to(compute_dtype)
            else:
                x = _conv1x1(x, conv, compute_dtype)
            x = torch.relu(x)
        return x

    def _forward_3d(self, x: torch.Tensor, compute_dtype) -> torch.Tensor:
        """Four ``F.conv3d`` in the compute dtype, each ``+ b`` then ReLU,
        on the NCDHW view of NDHWC ``x`` (``channels_last_3d`` in memory)."""
        x = _to_channels_first(x.to(compute_dtype))
        for conv in self.conv_pass[::2]:
            y = F.conv3d(x, conv.weight.to(compute_dtype))
            x = torch.relu(y + conv.bias.to(compute_dtype)[:, None, None, None])
        return _to_channels_last(x)


class Upsample(nn.Module):
    """Transposed conv with kernel = stride = ``factor``, ``c -> c``
    channels, at funlib's ``r_up.<h>.<l>.up``."""

    def __init__(self, channels: int, factor: Sequence[int]):
        super().__init__()
        factor = tuple(factor)
        self.up = _CONV_TRANSPOSE[len(factor)](channels, channels, factor, stride=factor)

    def forward(self, x: torch.Tensor, compute_dtype) -> torch.Tensor:
        """``cellulus_tpu/models/unet.py:_upsample_tconv``: kernel = stride,
        so output blocks never overlap and each input pixel expands into
        its ``prod(factor)`` block by one channel matmul (compute-dtype
        inputs and weights, f32 sums, compute-dtype output), then the
        interleave, then ``+ b`` in the compute dtype."""
        factor = self.up.kernel_size
        ndim = len(factor)
        c_in, c_out = self.up.weight.shape[:2]
        # (C_in, C_out, *K) -> (C_in, *K, C_out) -> (C_in, prod(K) * C_out)
        w = self.up.weight.to(compute_dtype).float()
        w = w.permute(0, *range(2, 2 + ndim), 1).reshape(c_in, -1)
        y = torch.matmul(x.to(compute_dtype).float(), w).to(compute_dtype)
        batch, spatial = x.shape[0], x.shape[1:-1]
        y = y.reshape(batch, *spatial, *factor, c_out)
        # (B, s0, .., f0, .., C) -> (B, s0, f0, s1, f1, .., C)
        perm = [0]
        for d in range(ndim):
            perm += [1 + d, 1 + ndim + d]
        y = y.permute(*perm, 1 + 2 * ndim)
        y = y.reshape(batch, *[s * f for s, f in zip(spatial, factor)], c_out)
        return y + self.up.bias.to(compute_dtype)


class Backbone(nn.Module):
    def __init__(self, in_channels, num_fmaps, fmap_inc_factor, num_levels, fmaps_out,
                 num_spatial_dims=2, up_factors=None):
        super().__init__()
        chans = [num_fmaps * fmap_inc_factor**level for level in range(num_levels)]
        self.l_conv = nn.ModuleList()
        c_prev = in_channels
        for level in range(num_levels):
            self.l_conv.append(ConvPass(c_prev, chans[level], num_spatial_dims))
            c_prev = chans[level]
        if up_factors is not None:
            self.r_up = nn.ModuleList([nn.ModuleList(
                [Upsample(chans[level + 1], up_factors[level]) for level in range(num_levels - 1)]
            )])
        up = nn.ModuleList()
        for level in range(num_levels - 1):
            c_out = fmaps_out if level == 0 else chans[level]
            up.append(ConvPass(chans[level] + chans[level + 1], c_out, num_spatial_dims))
        self.r_conv = nn.ModuleList([up])


def _max_pool(x: torch.Tensor, factor: Sequence[int]) -> torch.Tensor:
    """VALID max-pool of channels-last ``x`` (odd extents floor); the
    gradient goes to the first maximum of each window, as XLA's does."""
    y = _MAX_POOL[len(factor)](_to_channels_first(x), tuple(factor), tuple(factor))
    return _to_channels_last(y)


def _upsample_nearest(x: torch.Tensor, factor: Sequence[int]) -> torch.Tensor:
    for axis, f in enumerate(factor, start=1):
        if f > 1:
            x = x.repeat_interleave(f, dim=axis)
    return x


def _center_crop(x: torch.Tensor, target: Sequence[int]) -> torch.Tensor:
    crop = tuple(slice((s - t) // 2, (s - t) // 2 + t) for s, t in zip(x.shape[1:-1], target))
    return x[(slice(None),) + crop]


def _conv1x1(x: torch.Tensor, conv: nn.Module, compute_dtype) -> torch.Tensor:
    """A 1x1(x1) conv of channels-last ``x`` as a channel matmul:
    compute-dtype inputs and weights, f32 accumulation, compute-dtype output
    plus bias."""
    w = conv.weight.reshape(conv.weight.shape[:2]).to(compute_dtype).float()
    y = torch.matmul(x.float(), w.T).to(compute_dtype)
    return y + conv.bias.to(compute_dtype)


def _run(conv_pass: ConvPass, x, compute_dtype, fused: bool):
    return conv_pass(x, compute_dtype, fused)


def _remat(conv_pass: ConvPass, x, compute_dtype, fused: bool):
    """The pass under ``torch.utils.checkpoint`` (non-reentrant): only its
    input is kept, and the backward runs the pass again, 2D filter
    gradients through K2 as before (``cellulus_tpu/models/unet.py:315-316``,
    ``jax.checkpoint`` per pass)."""
    return torch.utils.checkpoint.checkpoint(conv_pass, x, compute_dtype, fused,
                                             use_reentrant=False)


class UNet(nn.Module):
    """U-Net + head: ``(B, *spatial, C_in) -> (B, *spatial_out, D)`` float32
    offsets, channel 0 = x (column) offset; 2 or 3 spatial dims."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_fmaps: int,
        fmap_inc_factor: int,
        features_in_last_layer: int,
        downsampling_factors: Sequence[Sequence[int]],
        num_spatial_dims: int = 2,
        constant_upsample: bool = True,
    ):
        super().__init__()
        if num_spatial_dims not in (2, 3):
            raise ValueError(f"the U-Net takes 2 or 3 spatial dims, not {num_spatial_dims}")
        self.downsampling_factors = [tuple(int(f) for f in fac) for fac in downsampling_factors]
        for fac in self.downsampling_factors:
            if len(fac) != num_spatial_dims:
                raise ValueError(
                    f"downsampling factor {fac} does not match {num_spatial_dims} spatial dims"
                )
        self.num_spatial_dims = num_spatial_dims
        self.constant_upsample = constant_upsample
        self.num_levels = len(self.downsampling_factors) + 1
        self.backbone = Backbone(
            in_channels, num_fmaps, fmap_inc_factor, self.num_levels, features_in_last_layer,
            num_spatial_dims, None if constant_upsample else self.downsampling_factors,
        )
        fil = features_in_last_layer
        conv = _CONV[num_spatial_dims]
        self.head = nn.Sequential(conv(fil, fil, 1), nn.ReLU(), conv(fil, out_channels, 1))
        # recompute each conv pass's activations in the backward (training
        # path only): train_config.remat
        self.remat = False

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        if x.dim() != self.num_spatial_dims + 2:
            raise ValueError(
                f"expected (B, *spatial, C) input with {self.num_spatial_dims} spatial dims, "
                f"got shape {tuple(x.shape)}"
            )
        # K1 defines no gradient: it runs only where none has to flow
        fused = not torch.is_grad_enabled() or not (
            x.requires_grad or any(p.requires_grad for p in self.parameters())
        )
        bb = self.backbone
        run = _remat if self.remat and not fused else _run
        skips = []
        for level in range(self.num_levels - 1):
            x = run(bb.l_conv[level], x, compute_dtype, fused)
            skips.append(x)
            x = _max_pool(x, self.downsampling_factors[level])
        x = run(bb.l_conv[self.num_levels - 1], x, compute_dtype, fused)
        for level in reversed(range(self.num_levels - 1)):
            if self.constant_upsample:
                x = _upsample_nearest(x, self.downsampling_factors[level])
            else:
                x = bb.r_up[0][level](x, compute_dtype)
            skip = _center_crop(skips[level], x.shape[1:-1])
            x = torch.cat([skip, x], dim=-1)
            x = run(bb.r_conv[0][level], x, compute_dtype, fused)
        x = torch.relu(_conv1x1(x, self.head[0], compute_dtype))
        return _conv1x1(x, self.head[2], compute_dtype).float()


def init_unet_(model: UNet, scheme: str, generator: torch.Generator) -> UNet:
    """Re-initialize every conv and transposed conv in place, drawing from
    ``generator``.

    The two schemes of ``cellulus_tpu/models/unet.py:_init_conv``:
    ``"kaiming_normal"`` draws weights from ``N(0, 2 / fan_in)`` (the
    reference's re-init for ``initialize=True``), ``"torch_default"`` from
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``; biases draw from that uniform in
    both. ``fan_in`` is ``weight[0].numel()``: ``C_in * prod(K)`` for a
    conv, ``C_out * prod(K)`` for a transposed conv, which is the JAX
    package's ``prod(factor) * c_up`` since its in and out channels are
    both ``c_up``. The stream is torch's, not JAX's: parity tests carry
    weights across with ``state_dict_from_jax_params`` instead.
    """
    if scheme not in ("kaiming_normal", "torch_default"):
        raise ValueError(f"unknown init scheme {scheme!r}")
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, nn.modules.conv._ConvNd):
                continue
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            if scheme == "kaiming_normal":
                w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            else:
                w.uniform_(-bound, bound, generator=generator)
            b = torch.empty(m.bias.shape, dtype=torch.float32).uniform_(
                -bound, bound, generator=generator
            )
            m.weight.copy_(w)
            m.bias.copy_(b)
    return model


def select_and_add_coordinates(
    outputs: torch.Tensor, coordinates: torch.Tensor
) -> torch.Tensor:
    """Gather offsets at pixel coordinates and add the coordinate.

    Args:
        outputs: ``(B, *spatial, D)`` predicted offsets (channels-last).
        coordinates: ``(B, P, D)`` integer coordinates, x-first
            (``[..., 0]`` = x/column, ``[..., 1]`` = y/row, ``[..., 2]`` = z), as in
            ``cellulus_tpu/models/unet.py:select_and_add_coordinates``.

    Returns:
        Absolute embeddings ``(B, P, D)``.
    """
    B, D = outputs.shape[0], outputs.shape[-1]
    spatial = outputs.shape[1:-1]
    flat = outputs.reshape(B, -1, D)
    # row-major flat index: ((z * H) + y) * W + x
    idx = torch.zeros(coordinates.shape[:-1], dtype=torch.long, device=outputs.device)
    stride = 1
    for d in range(len(spatial)):
        idx = idx + coordinates[..., d].long() * stride
        stride *= spatial[len(spatial) - 1 - d]
    gathered = torch.gather(flat, 1, idx[..., None].expand(*idx.shape, D))
    return gathered + coordinates.to(gathered.dtype)


def unet_from_config(model_config, in_channels: int, num_spatial_dims: int) -> UNet:
    return UNet(
        in_channels=in_channels,
        out_channels=num_spatial_dims,
        num_fmaps=model_config.num_fmaps,
        fmap_inc_factor=model_config.fmap_inc_factor,
        features_in_last_layer=model_config.features_in_last_layer,
        downsampling_factors=model_config.downsampling_factors,
        num_spatial_dims=num_spatial_dims,
        constant_upsample=model_config.constant_upsample,
    )


def tta_embeddings(
    model: UNet,
    tiles: torch.Tensor,
    uniform: torch.Tensor,
    p_salt_pepper: float,
    num_infer_iterations: int,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Test-time-augmented embeddings for a batch of tiles, in one forward.

    Args:
        tiles: ``(T, *spatial, C)`` normalized tiles, channels-last.
        uniform: ``(2 * num_infer_iterations, T, *spatial, C)`` draws from
            U[0, 1); a pixel is replaced by the copy's noise value (0.5 for
            the first half of the copies, 1.0 for the second) where its draw
            is ``<= p_salt_pepper``.

    Returns:
        ``(T, *spatial_out, D + 1)`` float32: the mean offsets over the
        copies, then the channel-summed population std (``correction=0``).
    """
    n = 2 * num_infer_iterations
    if uniform.shape != (n, *tiles.shape):
        raise ValueError(
            f"uniform draws must be {(n, *tiles.shape)}, got {tuple(uniform.shape)}"
        )
    noise_vals = torch.cat([
        torch.full((num_infer_iterations,), 0.5, dtype=tiles.dtype, device=tiles.device),
        torch.full((num_infer_iterations,), 1.0, dtype=tiles.dtype, device=tiles.device),
    ]).reshape((n,) + (1,) * tiles.dim())
    noisy = torch.where(uniform <= p_salt_pepper, noise_vals, tiles[None])
    preds = model(noisy.reshape(n * tiles.shape[0], *tiles.shape[1:]), compute_dtype)
    preds = preds.reshape(n, tiles.shape[0], *preds.shape[1:])
    mean = preds.mean(dim=0)
    std_sum = preds.std(dim=0, correction=0).sum(dim=-1, keepdim=True)
    return torch.cat([mean, std_sum], dim=-1)
