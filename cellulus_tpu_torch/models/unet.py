"""The object-centric-embedding U-Net as an ``nn.Module``.

Port of ``cellulus_tpu/models/unet.py:forward`` (2D, nearest-neighbour
upsampling): per level a valid ``[3,1,1,3]`` conv pass, max-pool on the way
down; on the way up nearest upsampling, a center crop of the skip by
``(size - target) // 2``, the concat ``[skip, up]`` and a conv pass; then the
head ``1x1 -> ReLU -> 1x1`` with no final activation.

Activations are channels-last (NHWC) throughout. ``forward`` takes one of
two paths, which compute the same function:

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

Parameters are stored in funlib's layout
and naming (``backbone.l_conv.<l>.conv_pass.<2i>``,
``backbone.r_conv.0.<l>.conv_pass.<2i>``, ``head.<0|2>``), so reference
``.pth`` checkpoints load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv_pass import conv_pass_2d
from ..ops.conv_vjp import conv3x3_valid

PASS_KERNELS = (3, 1, 1, 3)


class ConvPass(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        layers = []
        for k in PASS_KERNELS:
            layers += [nn.Conv2d(c_in, c_out, k), nn.ReLU()]
            c_in = c_out
        self.conv_pass = nn.Sequential(*layers)

    def pass_params(self) -> dict:
        """The pass's weights as ``(kh, kw, C_in, C_out)`` views."""
        convs = self.conv_pass[::2]
        return {
            f"conv{i}": {"w": conv.weight.permute(2, 3, 1, 0), "b": conv.bias}
            for i, conv in enumerate(convs)
        }

    def forward(self, x: torch.Tensor, compute_dtype, fused: bool) -> torch.Tensor:
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


class Backbone(nn.Module):
    def __init__(self, in_channels, num_fmaps, fmap_inc_factor, num_levels, fmaps_out):
        super().__init__()
        chans = [num_fmaps * fmap_inc_factor**level for level in range(num_levels)]
        self.l_conv = nn.ModuleList()
        c_prev = in_channels
        for level in range(num_levels):
            self.l_conv.append(ConvPass(c_prev, chans[level]))
            c_prev = chans[level]
        up = nn.ModuleList()
        for level in range(num_levels - 1):
            c_out = fmaps_out if level == 0 else chans[level]
            up.append(ConvPass(chans[level] + chans[level + 1], c_out))
        self.r_conv = nn.ModuleList([up])


def _max_pool(x: torch.Tensor, factor: Sequence[int]) -> torch.Tensor:
    """VALID max-pool of NHWC ``x`` (odd extents floor); the gradient goes
    to the first maximum of each window, as XLA's does."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), tuple(factor), tuple(factor))
    return y.permute(0, 2, 3, 1)


def _upsample_nearest(x: torch.Tensor, factor: Sequence[int]) -> torch.Tensor:
    for axis, f in enumerate(factor, start=1):
        if f > 1:
            x = x.repeat_interleave(f, dim=axis)
    return x


def _center_crop(x: torch.Tensor, target: Sequence[int]) -> torch.Tensor:
    (H, W), (th, tw) = x.shape[1:3], target
    oy, ox = (H - th) // 2, (W - tw) // 2
    return x[:, oy : oy + th, ox : ox + tw]


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d, compute_dtype) -> torch.Tensor:
    """A 1x1 conv of NHWC ``x`` as a channel matmul: compute-dtype inputs
    and weights, f32 accumulation, compute-dtype output plus bias."""
    w = conv.weight[:, :, 0, 0].to(compute_dtype).float()
    y = torch.matmul(x.float(), w.T).to(compute_dtype)
    return y + conv.bias.to(compute_dtype)


class UNet(nn.Module):
    """U-Net + head: ``(B, H, W, C_in) -> (B, H_out, W_out, D)`` float32
    offsets, channel 0 = x (column) offset."""

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
        if num_spatial_dims != 2:
            raise NotImplementedError(
                "3D U-Net is not ported yet (ROADMAP: M8, 3D main path)"
            )
        if not constant_upsample:
            raise NotImplementedError(
                "constant_upsample=False (transposed-conv upsampling) is not "
                "ported yet (ROADMAP: port queue, constant_upsample=False)"
            )
        self.downsampling_factors = [tuple(int(f) for f in fac) for fac in downsampling_factors]
        self.num_levels = len(self.downsampling_factors) + 1
        self.backbone = Backbone(
            in_channels, num_fmaps, fmap_inc_factor, self.num_levels, features_in_last_layer
        )
        fil = features_in_last_layer
        self.head = nn.Sequential(
            nn.Conv2d(fil, fil, 1), nn.ReLU(), nn.Conv2d(fil, out_channels, 1)
        )

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"expected (B, H, W, C) input, got shape {tuple(x.shape)}")
        # K1 defines no gradient: it runs only where none has to flow
        fused = not torch.is_grad_enabled() or not (
            x.requires_grad or any(p.requires_grad for p in self.parameters())
        )
        bb = self.backbone
        skips = []
        for level in range(self.num_levels - 1):
            x = bb.l_conv[level](x, compute_dtype, fused)
            skips.append(x)
            x = _max_pool(x, self.downsampling_factors[level])
        x = bb.l_conv[self.num_levels - 1](x, compute_dtype, fused)
        for level in reversed(range(self.num_levels - 1)):
            x = _upsample_nearest(x, self.downsampling_factors[level])
            skip = _center_crop(skips[level], x.shape[1:3])
            x = torch.cat([skip, x], dim=-1)
            x = bb.r_conv[0][level](x, compute_dtype, fused)
        x = torch.relu(_conv1x1(x, self.head[0], compute_dtype))
        return _conv1x1(x, self.head[2], compute_dtype).float()


def init_unet_(model: UNet, scheme: str, generator: torch.Generator) -> UNet:
    """Re-initialize every conv in place, drawing from ``generator``.

    The two schemes of ``cellulus_tpu/models/unet.py:_init_conv``:
    ``"kaiming_normal"`` draws weights from ``N(0, 2 / fan_in)`` (the
    reference's re-init for ``initialize=True``), ``"torch_default"`` from
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``; biases draw from that uniform in
    both. The stream is torch's, not JAX's: parity tests carry weights
    across with ``state_dict_from_jax_params`` instead.
    """
    if scheme not in ("kaiming_normal", "torch_default"):
        raise ValueError(f"unknown init scheme {scheme!r}")
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, nn.Conv2d):
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
        outputs: ``(B, H, W, D)`` predicted offsets (channels-last).
        coordinates: ``(B, P, D)`` integer coordinates, x-first
            (``[..., 0]`` = x/column, ``[..., 1]`` = y/row), as in
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
        tiles: ``(T, H, W, C)`` normalized tiles, channels-last.
        uniform: ``(2 * num_infer_iterations, T, H, W, C)`` draws from
            U[0, 1); a pixel is replaced by the copy's noise value (0.5 for
            the first half of the copies, 1.0 for the second) where its draw
            is ``<= p_salt_pepper``.

    Returns:
        ``(T, H_out, W_out, D + 1)`` float32: the mean offsets over the
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
