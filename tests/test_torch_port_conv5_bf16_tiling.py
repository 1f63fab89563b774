"""conv5's bf16 kernel (``csrc/conv5.cu::conv5_bf16_kernel``), emulated on the CPU.

The kernel computes the 5x5 "same" conv as an implicit GEMM whose A operand
is the weights (64 output channels x 16 input channels a tap) and whose B
operand is the input halo (16 input channels x 256 output positions a
warpgroup). A frame's outputs lie in rows of ``wp = ws + 4`` padded positions
(the first ``ws`` of each pixels of a strip), so that output position ``o``
reads, at tap (dy, dx), halo position ``o - y0 * wp + dy * wp + dx``. A tile
is 512 consecutive positions of a strip, two warpgroups of 256; a warpgroup
whose first position lies past the strip's last row computes and stores
nothing. A chunk's halo is two TMA boxes (one an 8-channel block) of ``rows``
input rows from ``y0 - 2`` by ``wp`` columns from ``strip * ws - 2``, zeros
outside the frame, in planes of ``plane`` bytes whose tail past the box holds
whatever an earlier stage left. Here:

* the wrapper's weight tiling (``bf16_weight_tiles``) puts each weight where
  the kernel's A descriptors (LBO 1024, SBO 128 bytes, K-major, no swizzle)
  read it, each chunk one contiguous bulk copy;
* the plan's geometry (``make_bf16_plan``: strips as wide as the shared
  memory allows, ``rows``, ``plane``, two stages beside the 64 KB of
  epilogue buffers);
* the epilogue's ``stmatrix .trans`` of wgmma's C fragment into the
  warpgroup's buffer: [position][64 channels], the 16-byte chunks of a
  position XOR-swizzled by its low 3 bits;
* the tile walk in numpy, the B descriptors' reads (LBO one plane, SBO 128
  bytes, a tap a 16-byte shift) included, the stale plane tails random:
  every tap of a valid output stays inside the box, no read leaves the
  plane, each pixel is stored once, and with inputs that are small
  multiples of powers of two (every float32 sum exact) the stores equal
  ``conv5_plain``'s bf16 contract bit for bit, at frames smaller than the
  halo, pixel counts off the tile, SAVi's 64 x 64 and frames wider than the
  halo's room (in strips).
"""

import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

from textocvp_tpu_torch.ops import conv5 as c5

KS, C, CK = 5, 64, 16           # kernel size, channels, input channels a chunk
BM, WG_N = 512, 256             # positions a tile, a warpgroup
EPI_N = WG_N // 2               # positions an epilogue pass
W_CHUNK = KS * KS * CK * C * 2  # bytes of a chunk's weights
HALO_STAGES, W_STAGES = 3, 2    # the two rings
EPI = 2 * EPI_N * C * 2         # bytes of the two epilogue buffers
SMEM_MAX, BOX_MAX = 232448 - 1024, 256


def geometry(ws):
    """``bf16_geometry``: (wp, rows, plane bytes, dynamic shared memory)."""
    wp = ws + KS - 1
    rows = (BM + wp - 2) // wp + 1 + KS - 1
    plane = ((rows * wp + KS - 1) * 16 + 127) // 128 * 128
    return wp, rows, plane, 128 + HALO_STAGES * 2 * plane + W_STAGES * W_CHUNK + EPI


def plan(h, w):
    """``make_bf16_plan``: {ws, strips, wp, rows, plane, smem} of an (h, w) frame."""
    for cap in range(min(w, BOX_MAX - (KS - 1)), 0, -1):
        strips = -(-w // cap)
        ws = -(-w // strips)
        wp, rows, plane, smem = geometry(ws)
        if smem <= SMEM_MAX and rows <= BOX_MAX:
            return {"ws": ws, "strips": strips, "wp": wp, "rows": rows, "plane": plane,
                    "smem": smem}
    raise ValueError((h, w))


def read_a(w_t, c, tap):
    """A (64 output channels x 16 input channels) of chunk c, tap ``tap``, as
    its descriptor reads the tiled bytes: element (m, k) at k // 8 * LBO +
    m // 8 * SBO + m % 8 * 16 + k % 8 * 2 bytes."""
    flat = w_t[c, tap].reshape(-1)  # bf16 elements of the tap's 2 KB
    m, k = np.meshgrid(np.arange(C), np.arange(CK), indexing="ij")
    return flat[(k // 8 * 1024 + m // 8 * 128 + m % 8 * 16 + k % 8 * 2) // 2]


def stmatrix_trans(frag, half):
    """The epilogue's shared-memory buffer after pass ``half`` (positions
    128 half .. 128 half + 127) of the 8 ``stmatrix .x4 .trans`` of each of a
    warpgroup's 4 warps: ``frag[warp][lane][j][e]`` is the lane's value of
    C-fragment register 4j + e (the kernel's v[e] at its step j), bf16 pairs
    (v[2i], v[2i + 1]) of matrix i; the addresses are the kernel's. Returns
    the buffer as (128 positions, 64 channels) bf16 elements in memory
    order."""
    buf = np.full(EPI_N * C, np.nan, dtype=np.float32)  # element (2-byte) units
    for warp in range(4):
        for j in range(0, 16, 2):
            # lane 8m + r addresses row r of matrix m
            addr = [(8 * (m >> 1) + r) * 128 + (((2 * warp + (m & 1)) ^ r) << 4) + j * 8 * 128
                    for m in range(4) for r in range(8)]
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for i in range(4):      # matrix i holds register i: (v[2i], v[2i + 1])
                    for b in range(2):
                        # .trans: element (row g, column 2t + b) goes to row
                        # 2t + b, column g of the matrix in memory
                        row = addr[8 * i + 2 * t + b]
                        buf[(row + 2 * g) // 2] = frag[warp][lane][8 * half + j // 2][2 * i + b]
    return buf.reshape(EPI_N, C)


def fragment(d):
    """wgmma's C fragment of D (64 channels x 256 positions) at the kernel's
    register order: lane (warp, 4g + t) at step j holds v[e] = D[16 warp + g +
    8 (e >> 1 & 1), 8 (j + (e >> 2)) + 2t + (e & 1)], j even."""
    frag = np.zeros((4, 32, 16, 8), dtype=np.float32)
    for warp in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for jj in range(16):
                for e in range(8):
                    frag[warp, lane, jj, e] = d[16 * warp + g + 8 * ((e >> 1) & 1),
                                                8 * (2 * jj + (e >> 2)) + 2 * t + (e & 1)]
    return frag


def emulate(x, w, b, relu, rng):
    """The kernel's walk over (frame, strip, tile) on bf16 inputs that are
    exact in float32 sums; returns the output as float32 (bf16 values)."""
    n, h, wd, _ = x.shape
    p = plan(h, wd)
    ws, strips, wp, rows, plane_pos = p["ws"], p["strips"], p["wp"], p["rows"], p["plane"] // 16
    assert wp <= BOX_MAX and rows <= BOX_MAX  # a TMA box
    w_t = c5.bf16_weight_tiles(w).float().numpy()
    xs = x.float().numpy().astype(np.float64)
    xpad = np.pad(xs, ((0, 0), (0, 0), (2, 2 + wp), (0, 0)))  # columns: 2 left, room right
    bias = b.numpy()
    out = np.full((n, h, wd, C), np.nan, dtype=np.float32)
    for frame, strip, mt in np.ndindex(n, strips, -(-h * wp // BM)):
        y0 = mt * BM // wp
        acc = np.zeros((2, C, WG_N), dtype=np.float64)
        for c in range(C // CK):
            # the stage: two planes of (positions, 8 channels), stale tails random
            planes = rng.integers(-64, 64, (2, plane_pos, 8)).astype(np.float64) / 8
            box = np.zeros((rows, wp, C), dtype=np.float64)
            for r in range(rows):  # TMA: columns from strip * ws - 2, zeros outside the frame
                iy = y0 - 2 + r
                if 0 <= iy < h:
                    box[r] = xpad[frame, iy, strip * ws:strip * ws + wp]
            box = box[:, :, CK * c:CK * (c + 1)].reshape(rows * wp, 2, 8)
            planes[:, :rows * wp] = box.transpose(1, 0, 2)
            for wg in range(2):
                o0 = mt * BM + WG_N * wg
                if o0 >= h * wp:
                    continue  # no position of this warpgroup lies in the frame
                base = o0 - y0 * wp
                for tap in range(KS * KS):
                    dy, dx = divmod(tap, KS)
                    pos = base + dy * wp + dx + np.arange(WG_N)  # B's 256 columns
                    assert pos.max() < plane_pos  # no read past the plane
                    # B (16 channels x 256 positions): channel k from plane k // 8
                    bmat = np.concatenate([planes[0, pos].T, planes[1, pos].T])
                    acc[wg] += read_a(w_t, c, tap).astype(np.float64) @ bmat
        for wg in range(2):
            o0 = mt * BM + WG_N * wg
            if o0 >= h * wp:
                continue
            o = o0 + np.arange(WG_N)
            y, xcol = o // wp, o % wp
            x_img = strip * ws + xcol
            valid = (y < h) & (xcol < ws) & (x_img < wd)
            # a valid output's taps stay inside the box
            local = o - y0 * wp
            assert (local[valid] + (KS - 1) * wp + KS - 1).max(initial=0) < rows * wp
            v = acc[wg].astype(np.float32) + bias[:, None]  # exact sums: the float32 sum
            if relu:
                v = np.maximum(v, np.float32(0))
            vb = torch.from_numpy(np.ascontiguousarray(v.T)).to(torch.bfloat16).float().numpy()
            # two passes through the buffer: the pass's position pos, 16-byte
            # chunk ch at chunk ch ^ (pos & 7); the stores read 16 bytes a
            # thread, chunk ch of position pos back from its slot
            stored = np.empty((WG_N, C), dtype=np.float32)
            swz = np.arange(8)[None, :] ^ (np.arange(EPI_N)[:, None] & 7)
            for half in range(2):
                buf = np.empty((EPI_N, 8, 8), dtype=np.float32)
                rows_of = np.arange(EPI_N)[:, None]
                buf[rows_of, swz] = vb[EPI_N * half:EPI_N * (half + 1)].reshape(EPI_N, 8, 8)
                stored[EPI_N * half:EPI_N * (half + 1)] = buf[rows_of, swz].reshape(EPI_N, C)
            assert np.isnan(out[frame, y[valid], x_img[valid]]).all()  # each pixel stored once
            out[frame, y[valid], x_img[valid]] = stored[valid]
    assert not np.isnan(out).any()  # every pixel stored
    return torch.from_numpy(out)


def _case(n, h, w, seed):
    """bf16 inputs that are small multiples of powers of two: x in k / 8,
    w in k / 32, b in k / 16, so that every product and every float32 sum of
    the 1600 terms of an output is exact in any order."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randint(-8, 9, (n, h, w, C), generator=g) / 8).to(torch.bfloat16)
    wt = (torch.randint(-16, 17, (KS, KS, C, C), generator=g) / 32).to(torch.bfloat16)
    b = torch.randint(-16, 17, (C,), generator=g) / 16
    return x, wt, b.float()


def test_weight_tiles_put_each_weight_where_the_a_descriptors_read_it():
    g = torch.Generator().manual_seed(5)
    w = torch.randn((KS, KS, C, C), generator=g).to(torch.bfloat16)
    w_t = c5.bf16_weight_tiles(w)
    assert w_t.is_contiguous() and w_t.dtype == torch.bfloat16
    assert w_t.shape == (C // CK, KS * KS, 2, C, 8)
    # each chunk's 25 taps are the contiguous 51,200 bytes of one bulk copy
    assert w_t[0].numel() * 2 == W_CHUNK
    wn, tn = w.float().numpy(), w_t.float().numpy()
    for c in range(C // CK):
        for tap in range(KS * KS):
            dy, dx = divmod(tap, KS)
            # A[m = output channel, k = input channel 16c + k]
            assert np.array_equal(read_a(tn, c, tap), wn[dy, dx, CK * c:CK * (c + 1)].T)


@pytest.mark.parametrize("h,w,want", [
    (64, 64, {"ws": 64, "strips": 1, "wp": 68, "rows": 13, "plane": 14208, "smem": 220544}),
    (1, 1, {"ws": 1, "strips": 1, "wp": 5, "rows": 108, "plane": 8704, "smem": 187520}),
    (9, 300, {"ws": 75, "strips": 4, "wp": 79, "rows": 12, "plane": 15232, "smem": 226688}),
    (16, 16, {"ws": 16, "strips": 1, "wp": 20, "rows": 31, "plane": 9984, "smem": 195200}),
    (5, 79, {"ws": 79, "strips": 1, "wp": 83, "rows": 12, "plane": 16000, "smem": 231296}),
    (5, 80, {"ws": 40, "strips": 2, "wp": 44, "rows": 17, "plane": 12032, "smem": 207488})])
def test_the_plan_fits_both_rings_and_the_epilogue_and_covers_a_tile(h, w, want):
    """SAVi's 64 x 64 at 13 rows of 68, as the kernel's header says; the
    widest strip whose stages fit (79 pixels), and frames past it in strips."""
    got = plan(h, w)
    assert got == want
    assert got["smem"] <= SMEM_MAX and got["wp"] <= BOX_MAX and got["rows"] <= BOX_MAX
    assert got["ws"] * got["strips"] >= w > got["ws"] * (got["strips"] - 1)
    wp, rows = got["wp"], got["rows"]
    # the worst tile start, the last position of a padded row: its last
    # position's last tap still lies in the box
    o0 = wp - 1
    assert (o0 + BM - 1) // wp + KS - 1 - o0 // wp < rows


@pytest.mark.parametrize("half", [0, 1])
def test_stmatrix_trans_lays_the_fragment_out_by_position_with_swizzled_chunks(half):
    rng = np.random.default_rng(7)
    d = rng.standard_normal((C, WG_N)).astype(np.float32)  # (channel, position)
    buf = stmatrix_trans(fragment(d), half)
    assert not np.isnan(buf).any()  # every element written once
    # chunk ch (channels 8ch .. 8ch + 7) of the pass's position pos lies at chunk ch ^ (pos & 7)
    pos = np.arange(EPI_N)
    for ch in range(8):
        got = buf.reshape(EPI_N, 8, 8)[pos, ch ^ (pos & 7)]
        assert np.array_equal(got, d[8 * ch:8 * ch + 8, EPI_N * half + pos].T)
    # the 8 rows of one matrix (8 consecutive positions, one channel half of
    # one warp) lie in 8 distinct 16-byte bank groups: no conflict
    for warp in range(4):
        for half in range(2):
            assert sorted((2 * warp + half) ^ r for r in range(8)) == list(range(8))


@pytest.mark.parametrize("n,h,w", [(2, 64, 64), (2, 5, 7), (1, 1, 1), (3, 3, 2), (3, 17, 70),
                                   (2, 20, 30), (1, 3, 300), (1, 2, 520)])
@pytest.mark.parametrize("relu", [True, False])
def test_the_tile_walk_equals_the_plain_bf16_contract_bit_for_bit(n, h, w, relu):
    x, wt, b = _case(n, h, w, seed=n * 100 + h + w)
    got = emulate(x, wt, b, relu, np.random.default_rng(h * w))
    want = c5.conv5_plain(x, wt, b, relu)
    assert want.dtype == torch.bfloat16
    assert torch.equal(got, want.float())
