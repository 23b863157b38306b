"""PointRend decoder: a coarse UPerNet prediction refined at uncertain points.

Port of the JAX package's models/pointrend.py (the reference's
models/PointRend.py and utils/pointrend_utils.py), with the reference's
torch names: the coarse head under `partial_upernet` (models/upernet.py,
its final upsample left out), the point head's 1x1 `Conv1d`s under
`point_head.fc1`..`fc3` and `point_head.predictor`.
  * `point_sample`: bilinear samples of NCHW maps at normalised [0, 1]^2
    points ([x, y] order), as torch's grid_sample with align_corners=False
    and zero padding; (B, C, P) out.
  * Train mode: `num_points * oversample_ratio` uniform points, of which
    the `importance_sample_ratio * num_points` most uncertain (the
    smallest top-1 - top-2 logit margin of the coarse map) are kept,
    plus fresh uniform points. The uniforms are a `PointDraws`, which the
    train step draws from a generator seeded from (seed, step)
    (`draw_points`); a test may pass another framework's draws, or the
    points themselves. The point logits are scattered into the coarse map
    upsampled 4x (align_corners=False) at round(c * (side - 1)), rounding
    half to even; where two points land on one cell the last one wins
    (its value and its gradient), on the CPU and on the card alike.
  * Eval mode: log2(4) = 2 steps, each a 2x upsample of the map, then the
    `subdivision_num_points` most uncertain cells re-predicted by the
    point head and written back.
  * Uncertainty ranks ties by position (the lower index first), as JAX's
    `lax.top_k` does: a stable descending sort, on both devices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import to_f32
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.upernet import UPerNetDecoder
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear


@dataclass(frozen=True)
class PointDraws:
    """The train-time uniforms in [0, 1): `over` (N, num_points *
    oversample_ratio, 2) to choose from, `rand` (N, num_random, 2) or None."""
    over: torch.Tensor
    rand: torch.Tensor | None


def point_sample(feats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """NCHW `feats` sampled at (B, P, 2) normalised coords -> (B, C, P).
    The weights are computed in the coords' dtype."""
    n, c, h, w = feats.shape
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = feats.reshape(n, c, h * w)

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = flat.gather(2, idx[:, None, :].expand(n, c, idx.shape[1]))
        return vals * inside[:, None, :].to(vals.dtype)

    return (gather(y0, x0) * ((1 - wy) * (1 - wx))[:, None]
            + gather(y0, x0 + 1) * ((1 - wy) * wx)[:, None]
            + gather(y0 + 1, x0) * (wy * (1 - wx))[:, None]
            + gather(y0 + 1, x0 + 1) * (wy * wx)[:, None])


def calculate_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """top2 - top1 of the class axis (dim 1): higher is more uncertain."""
    top2 = torch.topk(logits, 2, dim=1).values
    return top2[:, 1] - top2[:, 0]


def top_k_first(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of each row of (B, M) `values`, largest
    first, equal values in ascending index order (JAX `lax.top_k`)."""
    return torch.sort(values, dim=1, descending=True, stable=True).indices[:, :k]


def point_counts(num_points: int, oversample_ratio: float,
                 importance_sample_ratio: float) -> tuple[int, int, int]:
    """(sampled, uncertain, random) point counts of a train step."""
    num_uncertain = int(importance_sample_ratio * num_points)
    return int(num_points * oversample_ratio), num_uncertain, num_points - num_uncertain


def draw_points(n: int, counts: tuple[int, int, int], generator: torch.Generator | None,
                device) -> PointDraws:
    """The uniforms of one train step, drawn on the CPU from `generator`
    (torch's global one when None) and moved to `device`."""
    sampled, _, random = counts
    over = torch.rand((n, sampled, 2), generator=generator)
    rand = torch.rand((n, random, 2), generator=generator) if random > 0 else None
    return PointDraws(over.to(device),
                      None if rand is None else rand.to(device))


def sample_uncertain_points(coarse: torch.Tensor, draws: PointDraws,
                            num_uncertain: int) -> torch.Tensor:
    """Train-time points (B, P, 2): the `num_uncertain` most uncertain of
    `draws.over` on the NCHW `coarse` map, then `draws.rand`."""
    unc = calculate_uncertainty(point_sample(coarse, draws.over))
    idx = top_k_first(unc, num_uncertain)
    picked = draws.over.gather(1, idx[..., None].expand(-1, -1, 2))
    return picked if draws.rand is None else torch.cat([picked, draws.rand], dim=1)


def uncertain_points_on_grid(logits: torch.Tensor, num_points: int):
    """Eval-time: the `num_points` most uncertain cells of NCHW `logits` ->
    (flat indices (B, P), float32 cell-centre coords (B, P, 2))."""
    n, _, h, w = logits.shape
    num_points = min(h * w, num_points)
    idx = top_k_first(calculate_uncertainty(logits).reshape(n, h * w), num_points)
    xs = (idx % w).to(torch.float32) / w + 0.5 / w
    ys = (idx // w).to(torch.float32) / h + 0.5 / h
    return idx, torch.stack([xs, ys], dim=-1)


def scatter_points(seg: torch.Tensor, idx: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """NCHW `seg` with (B, C, P) `vals` written at the flat cells (B, P)
    `idx`. Where several points share a cell the last one wins: its value
    is written by all of them and only it receives the gradient."""
    n, c, h, w = seg.shape
    p = idx.shape[1]
    vals = vals.to(seg.dtype)
    ids = torch.arange(p, device=idx.device).expand(n, p)
    owner = torch.full((n, h * w), -1, dtype=torch.int64, device=idx.device)
    owner = owner.scatter_reduce(1, idx, ids, "amax", include_self=True)
    win = owner.gather(1, idx)
    src = torch.where((win == ids)[:, None], vals,
                      vals.detach().gather(2, win[:, None].expand(n, c, p)))
    out = seg.reshape(n, c, h * w).scatter(2, idx[:, None].expand(n, c, p), src)
    return out.reshape(n, c, h, w)


class PointHead(nn.Module):
    """1x1 Conv1d MLP over per-point features, the coarse logits
    concatenated again after each layer (the reference's StandardPointHead)."""

    def __init__(self, fine_channels: int, num_classes: int, fc_dim: int = 256,
                 num_fc: int = 3):
        super().__init__()
        self.num_fc = num_fc
        c_in = fine_channels + num_classes
        for k in range(num_fc):
            setattr(self, f"fc{k + 1}", nn.Conv1d(c_in, fc_dim, 1))
            c_in = fc_dim + num_classes
        self.predictor = nn.Conv1d(c_in, num_classes, 1)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        x = torch.cat([fine, coarse.to(fine.dtype)], dim=1)
        for k in range(self.num_fc):
            x = torch.relu(getattr(self, f"fc{k + 1}")(x))
            x = torch.cat([x, coarse.to(x.dtype)], dim=1)
        return self.predictor(x)


class PointRendDecoder(nn.Module):
    def __init__(self, in_channels: Sequence[int], task: int = 2,
                 num_points: int = 196, oversample_ratio: float = 3.0,
                 importance_sample_ratio: float = 0.75,
                 subdivision_num_points: int = 784,
                 input_scales: Sequence[int] = (4, 8, 16, 32)):
        super().__init__()
        num_classes = taxonomy.TASK_NUM_CLASSES[task]
        self.counts = point_counts(num_points, oversample_ratio,
                                   importance_sample_ratio)
        self.subdivision_num_points = subdivision_num_points
        self.scale = int(input_scales[0])
        self.partial_upernet = UPerNetDecoder(in_channels, task=task,
                                              input_scales=input_scales,
                                              interpolate_result_up=False)
        self.point_head = PointHead(sum(in_channels), num_classes)

    def _refine(self, conv_out, seg, coords):
        fine = torch.cat([point_sample(c, coords) for c in conv_out[::-1]], dim=1)
        return self.point_head(fine, point_sample(seg, coords))

    def forward(self, conv_out: Sequence[torch.Tensor],
                points: PointDraws | torch.Tensor | None = None) -> dict:
        """Train mode: `points` are the step's draws (torch's global
        generator draws them when None) or the (B, P, 2) points themselves;
        eval mode ignores them."""
        _, coarse = self.partial_upernet(conv_out, full_res=False)
        if self.training:
            if isinstance(points, torch.Tensor):
                coords = points
            else:
                if points is None:
                    points = draw_points(coarse.shape[0], self.counts, None,
                                         coarse.device)
                with torch.no_grad():
                    coords = sample_uncertain_points(coarse, points, self.counts[1])
            point_logits = self._refine(conv_out, coarse, coords)
            h, w = coarse.shape[2] * self.scale, coarse.shape[3] * self.scale
            seg = resize_bilinear(coarse, (h, w), align_corners=False)
            xi = torch.round(coords[..., 0] * (w - 1)).long()
            yi = torch.round(coords[..., 1] * (h - 1)).long()
            return {"logits": to_f32(scatter_points(seg, yi * w + xi, point_logits)),
                    "coarse_logits": to_f32(seg),
                    "point_logits": to_f32(point_logits),
                    "point_coords": coords}
        seg = coarse
        for _ in range(self.scale.bit_length() - 1):       # log2(scale) steps
            seg = resize_bilinear(seg, (2 * seg.shape[2], 2 * seg.shape[3]),
                                  align_corners=False)
            idx, coords = uncertain_points_on_grid(seg, self.subdivision_num_points)
            seg = scatter_points(seg, idx, self._refine(conv_out, seg, coords))
        return {"logits": to_f32(seg)}
