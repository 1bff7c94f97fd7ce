"""Valid-convolution shape arithmetic for the OCE U-Net.

The reference hardcodes ``output_shape = crop_size - 16`` for its default
1-level / 2x configuration (reference ``datasets/zarr_dataset.py:94``). Here
the exact input/output geometry is computed for any number of levels and
anisotropic downsampling factors, which the tiled-inference scheduler and the
training-coordinate sampler both rely on.

Per U-Net level, the conv pass uses kernel sizes ``[3, 1, 1, 3]`` in every
spatial dimension (reference ``models/unet.py:32-49``), so each pass shrinks
every spatial dim by 4. Max-pooling uses VALID padding (floors on odd sizes),
constant upsampling multiplies by the factor, and skip connections are
center-cropped to the upsampled size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

PASS_SHRINK = 4  # [3,1,1,3] valid convs: 2 + 0 + 0 + 2 per spatial dim


@dataclass(frozen=True)
class UNetGeometry:
    """Spatial sizes at every stage of the U-Net for one input size."""

    input_size: Tuple[int, ...]
    skip_sizes: List[Tuple[int, ...]]  # after each down conv pass (pre-pool)
    bottom_size: Tuple[int, ...]
    up_sizes: List[Tuple[int, ...]]  # after each up conv pass, top last
    output_size: Tuple[int, ...]

    @property
    def context(self) -> Tuple[int, ...]:
        """Half of (input - output) per spatial dim: the halo a tile needs."""
        return tuple((i - o) // 2 for i, o in zip(self.input_size, self.output_size))


def compute_geometry(
    input_size: Sequence[int], downsampling_factors: Sequence[Sequence[int]]
) -> UNetGeometry:
    """Trace the spatial sizes of a valid U-Net forward pass.

    Raises ValueError if the input is too small for the architecture.
    """
    ndim = len(input_size)
    size = tuple(int(s) for s in input_size)
    factors = [tuple(int(f) for f in fac) for fac in downsampling_factors]
    for fac in factors:
        if len(fac) != ndim:
            raise ValueError(
                f"downsampling factor {fac} does not match {ndim} spatial dims"
            )

    skip_sizes: List[Tuple[int, ...]] = []
    for fac in factors:
        size = tuple(s - PASS_SHRINK for s in size)
        if any(s <= 0 for s in size):
            raise ValueError(f"input {tuple(input_size)} too small for U-Net")
        skip_sizes.append(size)
        size = tuple(s // f for s, f in zip(size, fac))
        if any(s <= 0 for s in size):
            raise ValueError(f"input {tuple(input_size)} too small for U-Net")

    size = tuple(s - PASS_SHRINK for s in size)
    if any(s <= 0 for s in size):
        raise ValueError(f"input {tuple(input_size)} too small for U-Net")
    bottom = size

    up_sizes: List[Tuple[int, ...]] = []
    for level in reversed(range(len(factors))):
        fac = factors[level]
        size = tuple(s * f for s, f in zip(size, fac))
        skip = skip_sizes[level]
        if any(u > k for u, k in zip(size, skip)):
            raise ValueError(
                f"upsampled size {size} exceeds skip size {skip}; "
                f"input {tuple(input_size)} is not valid for this U-Net"
            )
        size = tuple(s - PASS_SHRINK for s in size)
        if any(s <= 0 for s in size):
            raise ValueError(f"input {tuple(input_size)} too small for U-Net")
        up_sizes.append(size)

    return UNetGeometry(
        input_size=tuple(int(s) for s in input_size),
        skip_sizes=skip_sizes,
        bottom_size=bottom,
        up_sizes=up_sizes,
        output_size=size,
    )


def conv_pass_inputs(
    input_size: Sequence[int],
    downsampling_factors: Sequence[Sequence[int]],
    in_channels: int,
    num_fmaps: int,
    fmap_inc_factor: int,
    features_in_last_layer: int,
) -> List[Tuple[str, Tuple[int, ...], int, int]]:
    """``(name, input spatial size, C_in, C_out)`` of every conv pass of one
    forward, in order: ``down``, ``down1``, .., ``bottom``, then the up
    passes from the deepest to ``up`` (level 0)."""
    g = compute_geometry(input_size, downsampling_factors)
    factors = [tuple(int(f) for f in fac) for fac in downsampling_factors]
    chans = [num_fmaps * fmap_inc_factor**level for level in range(len(factors) + 1)]
    passes = []
    size, c_prev = tuple(int(s) for s in input_size), in_channels
    for level, fac in enumerate(factors):
        passes.append((f"down{level or ''}", size, c_prev, chans[level]))
        c_prev = chans[level]
        size = tuple(s // f for s, f in zip(g.skip_sizes[level], fac))
    passes.append(("bottom", size, c_prev, chans[-1]))
    size = g.bottom_size
    for i, level in enumerate(reversed(range(len(factors)))):
        size = tuple(s * f for s, f in zip(size, factors[level]))
        c_out = features_in_last_layer if level == 0 else chans[level]
        passes.append((f"up{level or ''}", size, chans[level] + chans[level + 1], c_out))
        size = g.up_sizes[i]
    return passes


def output_size(
    input_size: Sequence[int], downsampling_factors: Sequence[Sequence[int]]
) -> Tuple[int, ...]:
    return compute_geometry(input_size, downsampling_factors).output_size


def min_input_size(downsampling_factors: Sequence[Sequence[int]]) -> Tuple[int, ...]:
    """Smallest input per dim for which the U-Net produces >= 1 output pixel."""
    ndim = len(downsampling_factors[0]) if downsampling_factors else 2
    size = [1] * ndim
    while True:
        try:
            compute_geometry(size, downsampling_factors)
            return tuple(size)
        except ValueError:
            size = [s + 1 for s in size]
            if size[0] > 4096:
                raise RuntimeError("no valid input size found below 4096")
