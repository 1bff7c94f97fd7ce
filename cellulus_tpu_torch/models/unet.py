"""The object-centric-embedding U-Net as an ``nn.Module``.

Port of ``cellulus_tpu/models/unet.py:forward`` (2D, nearest-neighbour
upsampling): per level a valid ``[3,1,1,3]`` conv pass, max-pool on the way
down; on the way up nearest upsampling, a center crop of the skip by
``(size - target) // 2``, the concat ``[skip, up]`` and a conv pass; then the
head ``1x1 -> ReLU -> 1x1`` with no final activation.

Activations are channels-last (NHWC) throughout, and every conv pass runs
through :func:`~cellulus_tpu_torch.ops.conv_pass.conv_pass_2d` (the
hand-written kernel on the card). Parameters are stored in funlib's layout
and naming (``backbone.l_conv.<l>.conv_pass.<2i>``,
``backbone.r_conv.0.<l>.conv_pass.<2i>``, ``head.<0|2>``), so reference
``.pth`` checkpoints load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.conv_pass import conv_pass_2d

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

    def forward(self, x: torch.Tensor, compute_dtype) -> torch.Tensor:
        return conv_pass_2d(x, self.pass_params(), compute_dtype)


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
    """VALID max-pool of NHWC ``x`` (odd extents floor)."""
    fy, fx = factor
    B, H, W, C = x.shape
    x = x[:, : H // fy * fy, : W // fx * fx]
    return x.reshape(B, H // fy, fy, W // fx, fx, C).amax(dim=(2, 4))


def _upsample_nearest(x: torch.Tensor, factor: Sequence[int]) -> torch.Tensor:
    for axis, f in enumerate(factor, start=1):
        if f > 1:
            x = x.repeat_interleave(f, dim=axis)
    return x


def _center_crop(x: torch.Tensor, target: Sequence[int]) -> torch.Tensor:
    (H, W), (th, tw) = x.shape[1:3], target
    oy, ox = (H - th) // 2, (W - tw) // 2
    return x[:, oy : oy + th, ox : ox + tw]


def _head_conv(x: torch.Tensor, conv: nn.Conv2d, compute_dtype) -> torch.Tensor:
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
        bb = self.backbone
        skips = []
        for level in range(self.num_levels - 1):
            x = bb.l_conv[level](x, compute_dtype)
            skips.append(x)
            x = _max_pool(x, self.downsampling_factors[level])
        x = bb.l_conv[self.num_levels - 1](x, compute_dtype)
        for level in reversed(range(self.num_levels - 1)):
            x = _upsample_nearest(x, self.downsampling_factors[level])
            skip = _center_crop(skips[level], x.shape[1:3])
            x = torch.cat([skip, x], dim=-1)
            x = bb.r_conv[0][level](x, compute_dtype)
        x = torch.relu(_head_conv(x, self.head[0], compute_dtype))
        return _head_conv(x, self.head[2], compute_dtype).float()


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
