"""Numpy emulation of the float32 arithmetic of the port's tensor-core
kernels (``csrc/conv_dw.cu``, ``csrc/conv_pass.cu``): 3xTF32.

Each float32 operand a is split into ``hi = tf32(a)``, the nearest value
with 10 mantissa bits, ties away from zero, on the bit pattern
(``(bits + 0x1000) & 0xFFFFE000``), and ``lo = a - hi``, which the tensor
core reads as TF32 by dropping its low 13 bits (``bits & 0xFFFFE000``); a
product a*b is taken as ``lo_a*hi_b + hi_a*lo_b + hi_a*hi_b``, summed in
float32. Used by the CPU
tests to show that this arithmetic meets the float32 tolerances against the
JAX package before the kernels run on the card.
"""

import numpy as np


def tf32(a):
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def truncate(a):
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    a = np.asarray(a, np.float32)
    hi = tf32(a)
    return hi, truncate(a - hi)


def matmul(a, b):
    """``a @ b`` (float32) as the kernels compute it: three TF32 products."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi).astype(np.float32)


def matmul_1x(a, b):
    """One TF32 product, for contrast: what the kernels do not do."""
    return (tf32(a) @ tf32(b)).astype(np.float32)


def conv3x3_dw(x, g, mm=matmul):
    """K2's filter gradient, ``(3, 3, Ci, Co)``, with ``mm`` per tap."""
    B, H, W, Ci = x.shape
    Ho, Wo, Co = H - 2, W - 2, g.shape[-1]
    gs = g.reshape(-1, Co)
    dw = np.empty((3, 3, Ci, Co), np.float32)
    for ky in range(3):
        for kx in range(3):
            xs = x[:, ky:ky + Ho, kx:kx + Wo].reshape(-1, Ci)
            dw[ky, kx] = mm(np.ascontiguousarray(xs.T), gs)
    return dw


def conv_pass(x, pass_params, mm=matmul):
    """K1's [3,1,1,3] pass, NHWC float32: each stage an im2col product with
    ``mm``, then the bias and ReLU, stored in float32."""
    y = np.asarray(x, np.float32)
    for i, k in enumerate((3, 1, 1, 3)):
        w = np.asarray(pass_params[f"conv{i}"]["w"], np.float32)
        b = np.asarray(pass_params[f"conv{i}"]["b"], np.float32)
        B, H, W, c = y.shape
        Ho, Wo = H - k + 1, W - k + 1
        cols = np.concatenate(
            [y[:, ky:ky + Ho, kx:kx + Wo] for ky in range(k) for kx in range(k)], axis=-1
        ).reshape(-1, k * k * c)
        out = mm(cols, w.reshape(k * k * c, -1)) + b
        y = np.maximum(out, 0).astype(np.float32).reshape(B, Ho, Wo, -1)
    return y
