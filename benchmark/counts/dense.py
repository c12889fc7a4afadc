"""The global solve's dense term (``solver/residuals.py::dense_pair_blocks``
over the dense-pair list, every GN iteration): the least time of the work
the run's counters say it did, whatever implements it.

Bytes, in each GN iteration: the frame cache of each keyframe in a live
pair, as a or as b, read once whole (its ten float channels: depth, point,
normal, intensity, gradient), however many pairs share it; and each live
pair's 12x12 block and 12-vector written once (156 floats). Operations: for
each valid-depth pixel of a, in each iteration, what it takes to reach the
association tests (:data:`FLOPS_PER_PIXEL`); for each depth association
and each colour association, the residual, its Jacobian and its share of
the blocks (:data:`FLOPS_PER_DEPTH`, :data:`FLOPS_PER_COLOR`). Slots that
are not live, pixels of a without depth, and the rest of the work of a
pixel that fails a test are not counted: their work is not needed. The
counters are the runlog's ``dense_pairs_live``, ``dense_frames_live``,
``dense_px_valid`` (a's valid pixels over the live pairs, the same in
every iteration), ``dense_assoc_depth`` and ``dense_assoc_color`` (summed
over the iterations)."""

from .peaks import bound

CHANNELS = 10
BYTES_PER_PAIR = (144 + 12) * 4
# a valid pixel's float operations up to the tests (a fused multiply-add
# counts two): a's point into b's camera (one transform a pair) 18, the
# projection 4, the bilinear weights 10, b's depth, point and normal
# sampled (7 channels of 7) 49, a's normal into b's camera 15, the
# difference and its squared length 3 + 5, the normals' dot product 5
FLOPS_PER_PIXEL = 18 + 4 + 10 + 49 + 15 + 3 + 5 + 5
# a depth association: the point-to-plane residual 5, its Jacobian 30 (b's
# half is a's negated), the weighted Jacobian 12, the symmetric 12x12 outer
# product (78 entries) 156, Jtr 24
FLOPS_PER_DEPTH = 5 + 30 + 12 + 156 + 24
# a colour association: b's intensity and gradient sampled (3 channels of
# 7) 21, the residual 1, the projection's derivative 6, the gradient
# through it 9 and through the pose 24, the gradient's length 3 and the
# weights 2, the weighted Jacobian 6 and its outer product (four 6x6
# blocks that are one up to sign: 21 entries) 42, Jtr 12
FLOPS_PER_COLOR = 21 + 1 + 6 + 9 + 24 + 3 + 2 + 6 + 42 + 12
# the projection's reciprocal of the depth
MUFU_PER_PIXEL = 1


def least_ms(live_pairs: int, frames: int, valid_px: int, assoc_depth: int, assoc_color: int, iters: int,
             frame_px: int) -> tuple[float, str]:
    """The least time of one chunk's dense term: ``iters`` GN iterations
    over ``live_pairs`` pairs of ``frames`` keyframes (``frame_px`` cached
    pixels each) holding ``valid_px`` valid pixels of a, with
    ``assoc_depth`` and ``assoc_color`` associations over all iterations."""
    nbytes = iters * (frames * frame_px * CHANNELS * 4 + live_pairs * BYTES_PER_PAIR)
    flops = iters * valid_px * FLOPS_PER_PIXEL + assoc_depth * FLOPS_PER_DEPTH + assoc_color * FLOPS_PER_COLOR
    return bound(nbytes, flops, iters * valid_px * MUFU_PER_PIXEL)
