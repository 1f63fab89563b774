"""The int8 conv kernel's tiling (``csrc/conv_int8.cu``), emulated on the CPU.

The kernel computes a k x k "same" conv as an implicit GEMM over padded
positions: a frame's outputs lie in rows of ``wp = W + k - 1`` positions (the
first W of each are pixels), so that output position ``o`` reads, at tap
(dy, dx), position ``o + dy * wp + dx`` of the staged halo. A tile is 256
consecutive positions of a frame; its halo is one TMA box of ``rows`` input
rows (from ``y0 - pad``, y0 the tile's first padded row) by ``wp`` columns
(from ``-pad``), zeros outside the frame, in planes of ``plane`` positions
whose tail past the box holds whatever an earlier stage left. A frame wider
than 257 - k columns goes in strips, each a frame of its own to the tile
walk but for its halo columns, which are the neighbour strip's pixels. Here:

* the weight tiling the wrapper hands the kernel (``weight_tiles``) holds
  each weight where the kernel's descriptors read it;
* the tile walk of the kernel, with its plan's ``rows`` and ``plane``
  (``make_plan``), in int64 numpy, the stale tails filled with random int8:
  every tap of a valid output stays inside the box, no read leaves the
  plane, each pixel is stored once, and the stored outputs equal
  ``conv_int8_plain`` bit for bit, at frames smaller than the halo, pixel
  counts off the tile, the SAVi tail and frames wider than a TMA box (in
  strips of 257 - k columns).
"""

import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

from textocvp_tpu_torch.ops import conv_int8 as ci

BM = 256  # csrc/conv_int8.cu: output positions a tile


def plan(w, k, bm=BM):
    """``make_plan``'s halo geometry: (strip width, strips, wp, rows, plane positions)."""
    ws = min(w, 256 - (k - 1))
    wp = ws + k - 1
    rows = (bm + wp - 2) // wp + 1 + k - 1
    plane = ((rows * wp + k - 1) * 16 + 127) // 128 * 128 // 16
    return ws, -(-w // ws), wp, rows, plane


def emulate(x_q, w_q, a_scale, w_scale, bias, relu, bm, rng):
    """The kernel's tile walk: halo boxes, shifted windows, dequantized stores."""
    n, h, w, cin = x_q.shape
    k, cout = w_q.shape[0], w_q.shape[3]
    pad = k // 2
    ws, strips, wp, rows, plane = plan(w, k, bm)
    assert wp <= 256 and rows <= 256  # a TMA box
    x = np.pad(x_q.numpy().astype(np.int64), ((0, 0), (0, 0), (pad, pad + wp), (0, 0)))
    wt = w_q.numpy().astype(np.int64)
    scale = (a_scale * w_scale).numpy()
    b = bias.numpy()
    out = np.full((n, h, w, cout), np.nan, dtype=np.float32)
    for frame, strip, mt in np.ndindex(n, strips, -(-h * wp // bm)):
        o0 = mt * bm
        y0 = o0 // wp
        halo = rng.integers(-128, 128, (plane, cin)).astype(np.int64)  # stale tail
        box = np.zeros((rows, wp, cin), dtype=np.int64)
        for r in range(rows):  # the box: columns from strip * ws - pad, zeros outside
            iy = y0 - pad + r
            if 0 <= iy < h:
                box[r] = x[frame, iy, strip * ws:strip * ws + wp]
        halo[:rows * wp] = box.reshape(rows * wp, cin)
        local = o0 - y0 * wp + np.arange(bm)
        acc = np.zeros((bm, cout), dtype=np.int64)
        for dy in range(k):
            for dx in range(k):
                src = local + dy * wp + dx
                assert src.max() < plane  # no read past the plane
                acc += halo[src] @ wt[dy, dx]
        pos = o0 + np.arange(bm)
        y, xs = pos // wp, pos % wp
        xx = strip * ws + xs
        valid = (y < h) & (xs < ws) & (xx < w)
        # a valid output's taps stay inside the box
        assert (local[valid] + (k - 1) * wp + k - 1).max(initial=0) < rows * wp
        vals = (acc[valid].astype(np.float32) * scale + b).astype(np.float32)
        assert np.isnan(out[frame, y[valid], xx[valid]]).all()  # each pixel stored once
        out[frame, y[valid], xx[valid]] = np.maximum(vals, 0) if relu else vals
    assert not np.isnan(out).any()  # every pixel stored
    return torch.from_numpy(out)


def _case(n, h, w, k, cin, cout, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(-127, 128, (n, h, w, cin), generator=g, dtype=torch.int8),
            torch.randint(-127, 128, (k, k, cin, cout), generator=g, dtype=torch.int8),
            torch.tensor(0.013), torch.rand(cout, generator=g) * 1e-3,
            torch.randn(cout, generator=g))


@pytest.mark.parametrize("k,cin,cout,ck,bn", [(5, 64, 64, 64, 64), (3, 768, 1024, 32, 128),
                                              (3, 128, 192, 64, 64)])
def test_weight_tiles_put_each_weight_where_the_kernel_reads_it(k, cin, cout, ck, bn):
    g = torch.Generator().manual_seed(3)
    w_q = torch.randint(-127, 128, (k, k, cin, cout), generator=g, dtype=torch.int8)
    w_t = ci.weight_tiles(w_q, ck, bn)
    assert w_t.is_contiguous()
    assert w_t.shape == (cout // bn, cin // ck, k * k, ck // 16, bn, 16)
    rng = np.random.default_rng(0)
    for _ in range(200):
        nt, c, tap, cb, co, i = (int(rng.integers(s)) for s in w_t.shape)
        assert w_t[nt, c, tap, cb, co, i] == w_q[tap // k, tap % k, c * ck + cb * 16 + i,
                                                 nt * bn + co]
    # each (output tile, chunk) block is the contiguous bytes one bulk copy moves
    flat = w_t.reshape(-1)
    block = k * k * ck * bn
    for i in range(flat.numel() // block):
        nt, c = divmod(i, cin // ck)
        assert torch.equal(flat[i * block:(i + 1) * block].reshape(w_t.shape[2:]), w_t[nt, c])


@pytest.mark.parametrize("n,h,w,k,cin,cout", [(2, 64, 64, 5, 64, 64), (2, 5, 7, 5, 64, 64),
                                              (1, 1, 1, 3, 64, 64), (3, 17, 20, 5, 64, 64),
                                              (2, 19, 23, 3, 128, 192), (1, 3, 130, 3, 64, 64),
                                              (1, 3, 300, 3, 64, 64), (2, 2, 520, 5, 64, 64)])
@pytest.mark.parametrize("relu", [True, False])
def test_the_tile_walk_equals_the_plain_conv_bit_for_bit(n, h, w, k, cin, cout, relu):
    args = _case(n, h, w, k, cin, cout, seed=n * 100 + h)
    got = emulate(*args, relu, BM, np.random.default_rng(h * w))
    assert torch.equal(got, ci.conv_int8_plain(*args, relu=relu))


@pytest.mark.parametrize("w,k,bm,rows", [(64, 5, 256, 9), (24, 3, 256, 13), (48, 3, 256, 9),
                                         (96, 3, 256, 6), (192, 3, 256, 5), (1, 3, 256, 88),
                                         (300, 3, 256, 4), (520, 5, 256, 6)])
def test_the_halo_box_covers_the_tile_and_fits_a_tma_box(w, k, bm, rows):
    """The CNN head's and SAVi's widths: the box heights the plan gives."""
    _, _, wp, got, plane = plan(w, k, bm)
    assert got == rows and wp <= 256 and rows <= 256
    # the worst tile start: the last position of a padded row
    o0 = wp - 1
    last = (o0 + bm - 1) // wp + k - 1 - o0 // wp
    assert last < rows
