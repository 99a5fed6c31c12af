"""The bf16 DRB kernel's addressing, emulated on the CPU.

``drb.cu::drb_kernel_bf16`` runs each stage as ``wgmma`` products whose
operands it names only by shared-memory descriptors: A is the channel-last
concat frame read at each kernel row's shifted start address, B the packed
weights in their canonical K-major layout with the three dx taps side by
side in N. A wrong stride there permutes results without any error, so
this file rebuilds the kernel's frame and reads both operands through the
descriptors' formulas with plain indexing:

* the frame: per group j (x, then out_1 .. out_4) F/8 slice planes of
  ``rows_j x pitch`` positions of 16 B (8 channels), group j's rows
  starting at ``max(ty0 - (5 - j), -1)``; at F = 8 a zero slice after
  group 4; a guard of 64 positions at the end;
* A of M-tile t, chunk c, kernel row dy: 8 core matrices of 8 positions x
  8 channels, element (m, k) at position ``start + (m // 8) * SBO + m % 8
  + (k // 8) * LBO`` (SBO = 6 positions, so neighbouring core matrices
  overlap by two rows; LBO = the step to the chunk's second 8-channel
  slice), channel k % 8, ``start`` moved by ``(dy - 1) * pitch`` for the
  row;
* B of k-step (c, dy): element (n, k), n = dx * F + co, at 16-B row
  ``(c * 3 + dy) * 6F + (n // 8) * 16 + n % 8 + (k // 8) * 8`` of the
  stage's packed weights;
* the epilogue: rows 1..6 of each core matrix are outputs, each the sum of
  its own dx = 1 column block and the dx = 0 and dx = 2 blocks of the rows
  above and below it (the kernel's lane shuffles); each stage covers its
  rectangle with M-tiles of 48 output positions, pitch pad columns and
  positions past the end computed and dropped.

Sums are float64 and the three rounding points the twin's, so the result
must equal ``drb_forward_reference(..., sum_dtype=torch.float64)`` exactly.
Every A read must also fall inside the frame the kernel allocates.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from downgan_tpu_torch.ops.cuda.drb import (  # noqa: E402
    RES_SCALE,
    SLOPE,
    bf16_chunks,
    drb_forward_reference,
    pack_drb_weights,
    packed_size,
)

from _torch_parity import one_thread  # noqa: E402,F401

TILE, HALO = 16, 5
M_TILE, GUARD = 64, 64  # wgmma's M; zero positions after the frame's last plane
SBO, M_OUT = 6, 48      # core-matrix step (positions); output positions per M-tile
DESC_UNITS = 1 << 14    # a descriptor's 14-bit fields count 16-B units


def group_rows(j, h):
    return min(TILE + 2 * (HALO - j), h + 2)


def frame_layout(f, h, pitch):
    """(base, plane, zero, positions): group j's slice 0 starts at position
    base[j] and each of its slices holds plane[j] positions; the zero slice
    (F = 8) starts at ``zero``; ``positions`` counts the guard too."""
    base, plane, pos = [], [], 0
    for j in range(5):
        plane.append(group_rows(j, h) * pitch)
        base.append(pos)
        pos += f // 8 * plane[j]
    zero = pos
    if f == 8:
        pos += group_rows(0, h) * pitch
    return base, plane, zero, pos + GUARD


def emulate_kernel(x, packed):
    """drb_kernel_bf16 on (B, F, H, W) bf16 ``x`` and its bf16 pack, with
    float64 sums; returns bf16 like the kernel."""
    b, f, h, w = x.shape
    nsl = f // 8
    pitch = TILE + 2 if w <= TILE else TILE + 2 * HALO
    base, plane, zero, positions = frame_layout(f, h, pitch)
    nbias = 5 * f
    bias = packed[-nbias:].view(torch.float32).double().reshape(5, f)
    wrows = packed[:-nbias].view(torch.bfloat16).double().reshape(-1, 8)  # 16-B rows
    stage_row = np.cumsum([0] + [bf16_chunks(f, s) * 9 * 2 * f for s in range(1, 6)])
    assert stage_row[-1] == wrows.shape[0]
    xd = x.double()
    out = torch.empty(b, f, h, w, dtype=torch.bfloat16)
    m = np.arange(M_TILE)
    k = np.arange(16)
    n = np.arange(3 * f)  # B columns: dx * f + co

    def rnd(t):
        return t.to(torch.bfloat16).double()

    for bi in range(b):
        for ty0 in range(0, h, TILE):
            for tx0 in range(0, w, TILE):
                fy0, fx0 = max(ty0 - HALO, -1), max(tx0 - HALO, -1)
                shift = [(max(ty0 - (HALO - j), -1) - fy0) * pitch for j in range(5)]

                def slice0(j, i):  # position of q = 0 in group j's slice i
                    return base[j] + i * plane[j] - shift[j]

                frame = torch.zeros(positions, 8, dtype=torch.float64)
                rows = np.arange(group_rows(0, h))
                cols = np.arange(pitch)
                gy, gx = np.meshgrid(fy0 + rows, fx0 + cols, indexing="ij")
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                q_in = (rows[:, None] * pitch + cols[None, :])[inside]
                for i in range(nsl):
                    vals = xd[bi, 8 * i:8 * i + 8][:, torch.from_numpy(gy[inside]),
                                                   torch.from_numpy(gx[inside])].T
                    frame[slice0(0, i) + q_in] = vals

                for s in range(1, 6):
                    e = HALO - s
                    cy0, cy1 = max(ty0 - e, 0), min(ty0 + TILE + e, h)
                    cx0, cx1 = max(tx0 - e, 0), min(tx0 + TILE + e, w)
                    q0 = (cy0 - fy0) * pitch + (cx0 - fx0)
                    q_last = (cy1 - 1 - fy0) * pitch + (cx1 - 1 - fx0)
                    ntiles = (q_last - q0) // M_OUT + 1
                    nch = bf16_chunks(f, s)
                    starts, lbos = [], []
                    for c in range(nch):
                        if f == 16:
                            starts.append(slice0(c, 0))
                            lbos.append(plane[c])
                        else:  # groups 2c and 2c+1, or the zero slice
                            a = slice0(2 * c, 0)
                            starts.append(a)
                            lbos.append((slice0(2 * c + 1, 0) if 2 * c + 1 < s else zero) - a)
                    rows_dy = np.array([(dy - 1) * pitch for dy in range(3)])
                    m_first = q0 - 1 + M_OUT * np.arange(ntiles)  # position of each tile's row 0
                    start = (np.array(starts)[None, :, None] + m_first[:, None, None]
                             + rows_dy[None, None, :])
                    lbo = np.array(lbos)[None, :, None, None, None]
                    m_pos = m // 8 * SBO + m % 8
                    a_pos = (start[..., None, None] + m_pos[:, None]
                             + (k // 8)[None, :] * lbo)  # (t, c, dy, m, k)
                    assert a_pos.min() >= 0 and a_pos.max() < positions
                    assert min(lbos) > 0 and max(lbos) < DESC_UNITS and positions < DESC_UNITS
                    a_tiles = frame[torch.from_numpy(a_pos), torch.from_numpy(k % 8)]
                    kstep = (np.arange(nch)[:, None] * 3 + np.arange(3)[None, :]) * 6 * f
                    b_row = (stage_row[s - 1] + kstep[..., None, None]
                             + (n // 8 * 16 + n % 8)[:, None] + (k // 8 * 8)[None, :])
                    b_ops = wrows[torch.from_numpy(b_row), torch.from_numpy(k % 8)]  # (c, dy, n, k)
                    d = torch.einsum("tcymk,cynk->tmn", a_tiles, b_ops)  # n = dx * f + co
                    inner = m[(m % 8 >= 1) & (m % 8 <= 6)]
                    acc = (bias[s - 1] + d[:, inner - 1, :f] + d[:, inner, f:2 * f]
                           + d[:, inner + 1, 2 * f:])  # (t, 48, f)

                    q = m_first[:, None] + m_pos[inner][None, :]
                    qy, qx = fy0 + q // pitch, fx0 + q % pitch
                    keep = torch.from_numpy((qy >= cy0) & (qy < cy1) & (qx >= cx0) & (qx < cx1))
                    kept = acc[keep]
                    qk = torch.from_numpy(q)[keep]
                    assert len(set(qk.tolist())) == len(qk) == (cy1 - cy0) * (cx1 - cx0)
                    if s < 5:
                        act = rnd(torch.nn.functional.leaky_relu(rnd(kept), SLOPE))
                        for i in range(nsl):
                            frame[slice0(s, i) + qk] = act[:, 8 * i:8 * i + 8]
                    else:
                        xv = torch.cat([frame[slice0(0, i) + qk] for i in range(nsl)], dim=1)
                        res = (rnd(kept) * RES_SCALE + xv).to(torch.bfloat16)
                        oy = torch.from_numpy(qy)[keep]
                        ox = torch.from_numpy(qx)[keep]
                        out[bi, :, oy, ox] = res.T
    return out


# Whole-sample florida tiles, a ragged image of 2 x 3 tiles, the domain
# band's 32x112 (halo'd tiles in two rows) and an image with a tile halo'd
# on all four sides, each at F = 16 and F = 8 (odd stages padded with the
# zero slice).
GEOMETRIES = [(2, 16, 16), (1, 20, 37), (1, 32, 112), (1, 48, 48)]


@pytest.mark.parametrize("f", [16, 8])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "B{}-{}x{}".format(*g))
def test_wgmma_addressing_emulation_matches_twin(geometry, f):
    b, h, w = geometry
    rng = np.random.default_rng(100 * f + h + w)
    ws, bs = [], []
    for s in range(1, 6):
        bound = 1.0 / np.sqrt(9 * s * f)
        ws.append(torch.from_numpy(rng.uniform(-bound, bound, (f, s * f, 3, 3)).astype(np.float32)))
        bs.append(torch.from_numpy(rng.uniform(-bound, bound, (f,)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((b, f, h, w)).astype(np.float32)).to(torch.bfloat16)
    packed = pack_drb_weights(ws, bs, torch.bfloat16)
    assert packed.numel() == packed_size(f, torch.bfloat16)
    got = emulate_kernel(x, packed)
    want = drb_forward_reference(x, ws, bs, sum_dtype=torch.float64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
