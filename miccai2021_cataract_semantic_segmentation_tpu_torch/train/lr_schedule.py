"""LR schedule engine with warm restarts (reference utils/lr_functions.py).

Port of the JAX package's train/lr_schedule.py: the same dense multiplier
table over all steps, built on the host in numpy (the port's own copy of
`build_multiplier_table`), and `make_schedule` returning a plain
`schedule(step) -> float` that reads it with a clipped index.

Forms (lr_functions.py:66-99): static, piecewise_static, exponential
(gamma default .98), polynomial (power default .9), cosine, each with
restart steps and per-restart base-value decay (`lr_restart_vals`: scalar
fraction compounding, or explicit list). The final "restart" at
lr_total_steps pins the base value to 0.
"""
from __future__ import annotations

import numpy as np


def build_multiplier_table(train_cfg: dict, total_steps: int) -> np.ndarray:
    """(total_steps + 1,) multiplier per scheduler step."""
    fct = train_cfg.get("lr_fct", "exponential")
    params = train_cfg.get("lr_params")
    restarts = [int(r) for r in train_cfg.get("lr_restarts", []) or []]
    restart_vals = train_cfg.get("lr_restart_vals", 1)

    if 0 not in restarts:
        restarts = [0] + restarts
    vals = [1.0]
    if isinstance(restart_vals, (int, float)):
        for _ in range(1, len(restarts)):
            vals.append(vals[-1] * restart_vals)
    else:
        if len(restart_vals) != len(restarts) - 1:
            raise ValueError("lr_restart_vals list must have len(lr_restarts) "
                             "entries")
        vals.extend(restart_vals)
    if total_steps not in restarts:
        restarts.append(total_steps)
        vals.append(0.0)
    restarts_arr = np.asarray(restarts)
    vals_arr = np.asarray(vals, dtype=np.float64)
    lengths = np.ones_like(restarts_arr)
    lengths[:-1] = restarts_arr[1:] - restarts_arr[:-1]

    steps = np.arange(total_steps + 1)
    seg = np.searchsorted(restarts_arr, steps, side="right") - 1
    seg = np.clip(seg, 0, len(restarts_arr) - 1)
    since = steps - restarts_arr[seg]
    base = vals_arr[seg]
    seg_len = lengths[seg]

    if fct == "static":
        table = base
    elif fct == "piecewise_static":
        schedule = params["piecewise_static_schedule"]
        table = np.zeros_like(base)
        prev_end = -1
        for phase_end, mult in schedule:
            sel = (steps > prev_end) & (steps <= phase_end)
            table[sel] = mult
            prev_end = phase_end
        table[steps > prev_end] = schedule[-1][1]
    elif fct == "exponential":
        gamma = 0.98 if params is None else params
        table = base * gamma ** since
    elif fct == "polynomial":
        power = 0.9 if params is None else params
        table = base * np.maximum(0.0, 1.0 - since / seg_len) ** power
    elif fct == "cosine":
        table = base * 0.5 * (1.0 + np.cos(np.pi * since / seg_len))
    else:
        raise ValueError(f"LR schedule '{fct}' not recognised")
    return table.astype(np.float32)


def make_schedule(train_cfg: dict, steps_per_epoch):
    """`schedule(step) -> lr` (a Python float). Epochwise schedules (the
    default) hold the multiplier constant within an epoch; `lr_batchwise:
    true` advances it per step, converting epoch-denominated restarts to
    batches (BaseManager.py:442-455). `steps_per_epoch` may be an int or a
    per-epoch sequence of step counts (repeat-factor epochs vary in
    length)."""
    base_lr = float(train_cfg.get("learning_rate", 1e-4))
    epochs = int(train_cfg.get("epochs", 50))
    if isinstance(steps_per_epoch, (int, np.integer)):
        lengths = np.full(epochs, int(steps_per_epoch), np.int64)
    else:
        lengths = np.asarray(list(steps_per_epoch)[:epochs], np.int64)
        if len(lengths) < epochs:
            lengths = np.concatenate([
                lengths, np.full(epochs - len(lengths),
                                 lengths[-1] if len(lengths) else 1, np.int64)])
    boundaries = np.concatenate([[0], np.cumsum(lengths)])
    cfg = dict(train_cfg)
    if train_cfg.get("lr_batchwise", False):
        cfg["lr_restarts"] = [int(boundaries[min(int(r), epochs)])
                              for r in (train_cfg.get("lr_restarts") or [])]
        table = build_multiplier_table(cfg, int(boundaries[-1]))
    else:
        table = build_multiplier_table(cfg, epochs)
        table = np.repeat(table[:epochs], lengths)
        table = np.append(table, table[-1])
    # float32, as the JAX package's table (multiplier and product alike)
    table = (table * np.float32(base_lr)).astype(np.float32)

    def schedule(step: int) -> float:
        return float(table[min(max(int(step), 0), len(table) - 1)])

    return schedule
