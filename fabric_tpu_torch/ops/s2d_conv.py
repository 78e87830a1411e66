"""Space-to-depth lane packing of 3x3 stride-1 SAME convolutions
(counterpart of ``fabric_tpu/ops/s2d_conv.py``), NHWC.

A 3x3 stride-1 SAME conv of (N, H, W, C) is exactly a 2x2 VALID conv of
the 1-px-shifted space-to-depth(2) tensor (N, H/2+1, W/2+1, 4C): 4x the
channels at 16/9 the multiply-adds (structural zero taps), plus the layout
shuffles.  The packed kernel is ``W2[a2, b2, (a, b, ci), (di, dj, co)] =
w[2*a2+a-1-di, 2*b2+b-1-dj, ci, co]``, zero where a tap falls outside
[-1, 1]; a chained second conv takes one :func:`reshift` of the first's
unshifted output instead of a d2s + s2d round trip.  ``fabric_tpu``
wrote this for the TPU's 128-lane matrix unit, where a 64-channel conv
fills half of it; it computes it with XLA convs, not Pallas, so this is
plain PyTorch: ``F.conv2d`` for the 2x2 VALID conv (cuDNN on the card, in
full float32 for float32: ``ops/fp32_conv.py``), and no hand kernel is
owed.

:func:`conv3x3_lane_packed` is the form the models train with
(``cfg.lane_pack``): the packed forward with ``fabric_tpu``'s hand-written
gradients, which are the direct conv's, since the packed forward *is* a
3x3 SAME conv: dgrad a 3x3 conv of the output gradient with the rotated,
in/out-swapped kernel (itself packed with ``pack_bwd`` where
:func:`supports` admits it), wgrad the direct conv's, and db the sum.

A level split over a mesh's spatial axis (``parallel/spatial.py``) takes
the VALID-in-H form (``pad_h=False``): the rank's rows come with the halo
rows that make them whole shifted s2d blocks of the global image (rows
(2j - 1, 2j): ``spatial.block_halo``), :func:`s2d` pads W alone, and the
2x2 conv yields the blocks' output rows, 2 fewer than it read.  An even
shard takes one halo row a side; an odd one (49 rows of 98) starts or ends
mid-block, so it takes one more on the side that reaches an even global
row and drops the extra output row.  Its gradients, for the
halo-extended input of h_e rows: dx the direct dgrad with H padding 2 (a
full correlation; packed, g with one zero row a side and a SAME packed
conv of h_e rows), dK the wgrad with padding (0, 1), db the sum; the
halo's backward hands each halo row's gradient to its owner.  Both gates
read the level's global height (``height``), as ``fabric_tpu``'s do under
GSPMD, where they see the global shape.

:func:`supports` is ``fabric_tpu``'s gate, copied as it is: it is the
flag's meaning (which convs pack, and so where the two packages round
alike), not a speed gate of the port.  Whether packing wins on the card is
``tools/ablate_train.py --microbench space_to_depth`` and ``--variant
full_lane_pack[_bwd]``'s question (``PERF.md``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fabric_tpu_torch.ops import fp32_conv, fp32_matmul


def _selection() -> np.ndarray:
    """S[a2,b2,a,b,di,dj,u,v] = 1 where packed-kernel cell (a2,b2), input
    phase (a,b), output sub-pixel (di,dj) reads direct-kernel tap (u,v)."""
    s = np.zeros((2, 2, 2, 2, 2, 2, 3, 3), np.float32)
    for a2 in range(2):
        for b2 in range(2):
            for a in range(2):
                for b in range(2):
                    for di in range(2):
                        for dj in range(2):
                            u = 2 * a2 + a - 1 - di
                            v = 2 * b2 + b - 1 - dj
                            if -1 <= u <= 1 and -1 <= v <= 1:
                                s[a2, b2, a, b, di, dj, u + 1, v + 1] = 1
    return s


_S = torch.from_numpy(_selection())

# the packed convs run since a caller last zeroed them: conv3x3_lane_packed's
# forwards and the dgrads that pack_bwd and the gate packed, and the eval
# forms (``models/blocks.Conv.packed``)
packed_counts = {"forward": 0, "dgrad": 0, "eval": 0}


def pack_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) HWIO kernel -> (2, 2, 4*Ci, 4*Co) s2d kernel, input
    block (a*2+b)*Ci + ci (phase-major), output block (di*2+dj)*Co + co
    (sub-pixel-major), matching :func:`s2d` / :func:`d2s`."""
    ci, co = kernel.shape[2], kernel.shape[3]
    w2 = fp32_matmul.einsum("ABabdeuv,uvic->ABabidec",
                            _S.to(kernel.device, kernel.dtype), kernel)
    return w2.reshape(2, 2, 4 * ci, 4 * co)


def s2d(x: torch.Tensor, pad_h: bool = True) -> torch.Tensor:
    """(N, H, W, C) -> shifted space-to-depth (N, H/2+1, W/2+1, 4C): 1 px
    of zeros on every side (the top/left pad is the phase shift), then
    2x2 pixel blocks into channels.  H and W must be even.  ``pad_h``
    False pads W alone, for rows that are whole shifted blocks already
    (N, H/2, W/2+1, 4C)."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d needs even H and W, got {h} x {w}")
    ph = int(pad_h)
    xp = F.pad(x, (0, 0, 1, 1, ph, ph))
    xr = xp.reshape(n, h // 2 + ph, 2, w // 2 + 1, 2, c)
    return xr.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2 + ph, w // 2 + 1,
                                                4 * c)


def d2s(y: torch.Tensor, cout: int) -> torch.Tensor:
    """(N, H/2, W/2, 4*Co) unshifted s2d -> (N, H, W, Co)."""
    n, h2, w2, _ = y.shape
    yr = y.reshape(n, h2, w2, 2, 2, cout)
    return yr.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h2, 2 * w2, cout)


def reshift(z: torch.Tensor, cout: int) -> torch.Tensor:
    """Unshifted s2d output (N, h2, w2, 4C) -> the shifted s2d input (N,
    h2+1, w2+1, 4C) of a chained second conv: xs[q, r, (a, b)] =
    zp[q+a, r+b, (1-a, 1-b)], zp zero-padded one block on each side."""
    n, h2, w2, _ = z.shape
    zp = F.pad(z.reshape(n, h2, w2, 2, 2, cout),
               (0, 0, 0, 0, 0, 0, 1, 1, 1, 1))
    rows = [torch.stack([zp[:, a:a + h2 + 1, b:b + w2 + 1, 1 - a, 1 - b]
                         for b in range(2)], dim=-2) for a in range(2)]
    return torch.stack(rows, dim=-3).reshape(n, h2 + 1, w2 + 1, 4 * cout)


def conv2x2(xs: torch.Tensor, w2: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """The packed conv: 2x2 VALID at 4*Ci -> 4*Co channels, NHWC, in xs's
    dtype; ``bias`` tiled over the four output sub-pixels and rounded to
    that dtype before it is added."""
    y = fp32_conv.conv(xs.permute(0, 3, 1, 2),
                       w2.to(xs.dtype).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.repeat(4).to(y.dtype)
    return y


def direct_conv3x3(x: torch.Tensor, kernel: torch.Tensor,
                   pad_rows: int = 1) -> torch.Tensor:
    """The direct 3x3 conv of NHWC x by an HWIO kernel, in x's dtype,
    without a bias: SAME, or with ``pad_rows`` rows of zeros above and
    below (W SAME either way)."""
    y = fp32_conv.conv(x.permute(0, 3, 1, 2),
                       kernel.to(x.dtype).permute(3, 2, 0, 1),
                       padding=(pad_rows, 1))
    return y.permute(0, 2, 3, 1)


def s2d_conv3x3(x: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor | None = None, *,
                relu: bool = False, pad_h: bool = True) -> torch.Tensor:
    """One 3x3 SAME stride-1 conv by lane packing (s2d, 2x2 conv, d2s);
    ``pad_h`` False: VALID in H, of rows that are whole shifted blocks
    (H - 2 output rows)."""
    y = conv2x2(s2d(x, pad_h), pack_kernel(kernel.to(x.dtype)), bias)
    if relu:
        y = torch.relu(y)
    return d2s(y, kernel.shape[-1])


def s2d_double_conv(x: torch.Tensor, k1, b1, k2, b2, *,
                    extra: torch.Tensor | None = None,
                    k1_extra=None) -> torch.Tensor:
    """(conv3x3 -> bias -> ReLU) x 2 in s2d space: one s2d, one reshift and
    one d2s for the pair.  ``extra`` / ``k1_extra``: a second input summed
    into the first conv (the split-concat decoder form, conv(skip, Ka) +
    conv(up, Kb))."""
    y = conv2x2(s2d(x), pack_kernel(k1.to(x.dtype)), b1)
    if extra is not None:
        y = y + conv2x2(s2d(extra), pack_kernel(k1_extra.to(extra.dtype)))
    y = conv2x2(reshift(torch.relu(y), k1.shape[-1]),
                pack_kernel(k2.to(x.dtype)), b2)
    return d2s(torch.relu(y), k2.shape[-1])


class _LanePacked(torch.autograd.Function):
    """:func:`s2d_conv3x3` forward, the direct conv's gradients."""

    @staticmethod
    def forward(ctx, x, kernel, bias, pack_bwd, pad_h, height):
        ctx.save_for_backward(x, kernel)
        ctx.conf = (pack_bwd, pad_h, height, bias.dtype)
        packed_counts["forward"] += 1
        return s2d_conv3x3(x, kernel, bias, pad_h=pad_h)

    @staticmethod
    def backward(ctx, g):
        # a gradient nobody asked for is not computed (XLA drops it as
        # dead code in fabric_tpu): the input image's dgrad, in inc
        x, kernel = ctx.saved_tensors
        pack_bwd, pad_h, height, bias_dtype = ctx.conf
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            kt = kernel.flip(0, 1).transpose(2, 3)
            if pack_bwd and supports(height or g.shape[1], g.shape[2],
                                     kt.shape[2], kt.shape[3]):
                # VALID in H: the full correlation, the SAME conv of g
                # with a zero row above and below
                dx = s2d_conv3x3(
                    g if pad_h else F.pad(g, (0, 0, 0, 0, 1, 1)), kt)
                packed_counts["dgrad"] += 1
            else:
                dx = direct_conv3x3(g, kt, 1 if pad_h else 2)
        if ctx.needs_input_grad[1]:
            with fp32_conv.no_tf32():
                dk = torch.nn.grad.conv2d_weight(
                    x.permute(0, 3, 1, 2),
                    (kernel.shape[3], kernel.shape[2], 3, 3),
                    g.permute(0, 3, 1, 2),
                    padding=(int(pad_h), 1)).permute(2, 3, 1, 0)
            dk = dk.to(kernel.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2)).to(bias_dtype)
        return dx, dk, db, None, None, None


def conv3x3_lane_packed(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, pack_bwd: bool = False, *,
                        pad_h: bool = True,
                        height: int | None = None) -> torch.Tensor:
    """:func:`s2d_conv3x3` (x and ``kernel`` in one dtype, ``bias`` any)
    with ``fabric_tpu``'s hand-written gradients (its ``custom_vjp``):

      dx = conv3x3(g, rot180(K) with in/out swapped)  [packed when
           ``pack_bwd`` and :func:`supports` admit it]
      dK = the direct conv's wgrad
      db = sum of g over N, H, W

    ``pad_h`` False: the VALID-in-H form of whole shifted blocks (the
    module docstring), with its gradients.  ``height``: the image's global
    rows, which the dgrad's gate reads (g's own rows when None).
    """
    return _LanePacked.apply(x, kernel, bias, pack_bwd, pad_h, height)


def supports(h: int, w: int, cin: int, cout: int) -> bool:
    """``fabric_tpu``'s gate: even H and W, Cout < 128 and a side of at
    least 96 (``cin`` is not read, as there)."""
    return h % 2 == 0 and w % 2 == 0 and cout < 128 and min(h, w) >= 96
