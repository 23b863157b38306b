"""CaDIS class taxonomy, task remappings, video splits, and dataset statistics.

Ground-truth semantics mirror the reference's utils/defaults.py (the CaDIS
benchmark definition): 36 canonical classes, three task granularities
(task 1: 8 classes, task 2: 17 classes + ignore, task 3: 25 classes + ignore),
pre-defined video splits, per-class pixel frequencies, and the oversampling /
rare-class presets used by the paper.

Everything here is static data, expressed as numpy LUTs so the device-side
remap is a single gather.

The PyTorch port keeps its own copy of the JAX package's taxonomy.py (the
port imports nothing of the JAX package); tests/test_torch_model.py holds
the two copies equal.
"""
from __future__ import annotations

import numpy as np

IGNORE_VALUE = 255  # canonical "ignore" id in CaDIS task 2/3 label space

# ---------------------------------------------------------------------------
# Canonical (task-0) class names, ids 0..35. Reference: utils/defaults.py:73-110
# ---------------------------------------------------------------------------
CANONICAL_NAMES: tuple[str, ...] = (
    "Pupil", "Surgical Tape", "Hand", "Eye Retractors", "Iris", "Skin",
    "Cornea", "Hydrodissection Cannula", "Viscoelastic Cannula",
    "Capsulorhexis Cystotome", "Rycroft Cannula", "Bonn Forceps",
    "Primary Knife", "Phacoemulsifier Handpiece", "Lens Injector",
    "I/A Handpiece", "Secondary Knife", "Micromanipulator",
    "I/A Handpiece Handle", "Capsulorhexis Forceps", "Rycroft Cannula Handle",
    "Phacoemulsifier Handpiece Handle", "Capsulorhexis Cystotome Handle",
    "Secondary Knife Handle", "Lens Injector Handle", "Suture Needle",
    "Needle Holder", "Charleux Cannula", "Primary Knife Handle",
    "Vitrectomy Handpiece", "Mendez Ring", "Marker",
    "Hydrodissection Cannula Handle", "Troutman Forceps", "Cotton",
    "Iris Hooks",
)
NUM_CANONICAL = len(CANONICAL_NAMES)  # 36

# ---------------------------------------------------------------------------
# Task groupings: task id -> {task class id: (canonical ids merged into it)}.
# Canonical ids not listed for a task map to IGNORE_VALUE.
# Reference: utils/defaults.py:112-230 (class_remapping_exp1/2/3)
# ---------------------------------------------------------------------------
TASK_GROUPS: dict[int, dict[int, tuple[int, ...]]] = {
    0: {i: (i,) for i in range(NUM_CANONICAL)},
    1: {
        **{i: (i,) for i in range(7)},
        7: tuple(range(7, NUM_CANONICAL)),  # every instrument -> "Instrument"
    },
    2: {
        **{i: (i,) for i in range(7)},
        7: (7, 8, 10, 27, 20, 32),   # Cannula
        8: (9, 22),                  # Cap. Cystotome
        9: (11, 33),                 # Tissue Forceps
        10: (12, 28),                # Primary Knife
        11: (13, 21),                # Ph. Handpiece
        12: (14, 24),                # Lens Injector
        13: (15, 18),                # I/A Handpiece
        14: (16, 23),                # Secondary Knife
        15: (17,),                   # Micromanipulator
        16: (19,),                   # Cap. Forceps
        IGNORE_VALUE: (25, 26, 29, 30, 31, 34, 35),
    },
    3: {
        **{i: (i,) for i in range(25)},
        IGNORE_VALUE: (25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35),
    },
}

TASK_CLASS_NAMES: dict[int, tuple[str, ...]] = {
    0: CANONICAL_NAMES,
    1: CANONICAL_NAMES[:7] + ("Instrument",),
    2: CANONICAL_NAMES[:7] + (
        "Cannula", "Cap. Cystotome", "Tissue Forceps", "Primary Knife",
        "Ph. Handpiece", "Lens Injector", "I/A Handpiece", "Secondary Knife",
        "Micromanipulator", "Cap. Forceps",
    ),
    3: CANONICAL_NAMES[:7] + (
        "Hydro. Cannula", "Visc. Cannula", "Cap. Cystotome", "Rycroft Cannula",
        "Bonn Forceps", "Primary Knife", "Ph. Handpiece", "Lens Injector",
        "I/A Handpiece", "Secondary Knife", "Micromanipulator",
        "I/A Handpiece Handle", "Cap. Forceps", "R. Cannula Handle",
        "Ph. Handpiece Handle", "Cap. Cystotome Handle", "Sec. Knife Handle",
        "Lens Injector Handle",
    ),
}

# Number of logit channels a network produces for each task (the 'ignore'
# class never gets a channel — reference models/OCR.py:41-42).
TASK_NUM_CLASSES: dict[int, int] = {t: len(names) for t, names in TASK_CLASS_NAMES.items()}
assert TASK_NUM_CLASSES == {0: 36, 1: 8, 2: 17, 3: 25}


def task_has_ignore(task: int) -> bool:
    """Tasks 2 and 3 carry an 'ignore' label (reference defaults.py:152,201)."""
    return task in (2, 3)


def ignore_index(task: int) -> int:
    """Label value that marks ignored pixels in network label space, or -1.

    In network label space the canonical 255 is remapped to num_classes
    (one past the last logit channel) — reference utils/utils.py:46.
    """
    return TASK_NUM_CLASSES[task] if task_has_ignore(task) else -1


def num_label_values(task: int) -> int:
    """Distinct label ids a network-space mask for `task` can contain."""
    return TASK_NUM_CLASSES[task] + (1 if task_has_ignore(task) else 0)


def _build_lut(task: int, to_network: bool) -> np.ndarray:
    """256-entry canonical-id -> task-id LUT (uint8); unlisted ids -> ignore."""
    lut = np.full(256, IGNORE_VALUE, dtype=np.uint8)
    for task_id, canon_ids in TASK_GROUPS[task].items():
        for c in canon_ids:
            lut[c] = task_id
    if to_network and task_has_ignore(task):
        lut[lut == IGNORE_VALUE] = TASK_NUM_CLASSES[task]
    return lut


# canonical -> task-paper ids (255 kept for ignore)
REMAP_LUTS: dict[int, np.ndarray] = {t: _build_lut(t, to_network=False) for t in TASK_GROUPS}
# canonical -> network ids (ignore folded to index num_classes)
REMAP_LUTS_NETWORK: dict[int, np.ndarray] = {t: _build_lut(t, to_network=True) for t in TASK_GROUPS}

# ---------------------------------------------------------------------------
# Category views for the mIoU breakdown. Reference: utils/defaults.py:11-33.
# "rare" sets were picked in the paper with freq_thresh 0.2 s.t. rf > 1.5.
# ---------------------------------------------------------------------------
CATEGORIES: dict[int, dict[str, tuple[int, ...]]] = {
    0: {"anatomies": (), "instruments": (), "others": (), "rare": ()},
    1: {
        "anatomies": (0, 4, 5, 6),
        "instruments": (7,),
        "others": (1, 2, 3),
        "rare": (2,),
    },
    2: {
        "anatomies": (0, 4, 5, 6),
        "instruments": tuple(range(7, 17)),
        "others": (1, 2, 3),
        "rare": (16, 10, 9, 12, 14),
    },
    3: {
        "anatomies": (0, 4, 5, 6),
        "instruments": tuple(range(7, 25)),
        "others": (1, 2, 3),
        "rare": (24, 20, 21, 22, 18, 23, 19, 16, 12, 11, 14),
    },
}

# ---------------------------------------------------------------------------
# Video splits [train, val(, test)] by video number. Reference: defaults.py:1-9
# ---------------------------------------------------------------------------
DATA_SPLITS: tuple[tuple[tuple[int, ...], ...], ...] = (
    ((1,), (5,)),  # split 0: debugging
    ((1, 3, 4, 6, 8, 9, 10, 11, 13, 14, 15, 17, 18, 19, 20, 21, 23, 24, 25),
     (5, 7, 16, 2, 12, 22)),  # split 1: train / [val+test]
    ((1, 3, 4, 6, 8, 9, 10, 11, 13, 14, 15, 17, 18, 19, 20, 21, 23, 24, 25),
     (5, 7, 16), (2, 12, 22)),  # split 2: train / val / test (paper split)
    (tuple(range(1, 26)), (5, 7, 16, 2, 12, 22)),  # split 3: all data
    ((1, 8, 9, 10, 14, 15, 21, 23, 24), (5, 7, 16, 2, 12, 22)),  # ~50% of data
    ((10, 14, 21, 24), (5, 7, 16, 2, 12, 22)),  # ~25% of data
)

# ---------------------------------------------------------------------------
# Oversampling presets (per task, classes to duplicate frames for).
# Reference: defaults.py:244-255
# ---------------------------------------------------------------------------
OVERSAMPLING_PRESETS: dict[str, dict[int, tuple[int, ...]]] = {
    "default": {1: (3, 5, 7), 2: (7, 8, 15, 16), 3: (19, 20, 22, 24)},
    "rare": {t: CATEGORIES[t]["rare"] for t in (1, 2, 3)},
}

# ---------------------------------------------------------------------------
# Global canonical-class pixel statistics over the dataset.
# Reference: defaults.py:257-332
# ---------------------------------------------------------------------------
CLASS_FREQUENCIES = np.array([
    1.68024535e-01, 5.93061223e-02, 7.38987570e-03, 5.72173439e-03,
    1.12288211e-01, 1.33608027e-01, 4.89257831e-01, 1.26300163e-03,
    8.96526043e-04, 9.28408858e-04, 6.47719387e-04, 2.61340734e-03,
    1.40455685e-03, 1.84766048e-03, 3.25327478e-03, 3.60986861e-03,
    1.06050077e-03, 1.97264561e-03, 5.32642854e-04, 7.07037962e-04,
    3.66272768e-04, 4.75095501e-04, 1.73250919e-04, 5.49602466e-04,
    2.91966965e-04, 1.06066764e-05, 1.54437472e-04, 4.16546878e-05,
    2.96828324e-06, 1.02785378e-04, 4.38665256e-04, 4.91079867e-04,
    1.13576281e-05, 1.83788200e-04, 1.37330396e-04, 2.35550169e-04,
])
CLASS_SUMS = np.array([
    406775301, 143575852, 17890357, 13851907, 271841675, 323455413,
    1184457982, 3057636, 2170425, 2247611, 1568082, 6326871, 3400331,
    4473053, 7875944, 8739232, 2567396, 4775633, 1289490, 1711688, 886720,
    1150172, 419428, 1330548, 706831, 25678, 373882, 100843, 7186, 248836,
    1061977, 1188869, 27496, 444938, 332467, 570250,
], dtype=np.int64)

# ---------------------------------------------------------------------------
# CaDIS paper colormap (canonical id -> RGB). Reference: utils/utils.py:67-111
# ---------------------------------------------------------------------------
CADIS_COLORMAP = np.array([
    [0, 137, 255], [255, 165, 0], [255, 156, 201], [99, 0, 255],
    [255, 0, 0], [255, 0, 165], [255, 255, 255], [141, 141, 141],
    [255, 218, 0], [173, 156, 255], [73, 73, 73], [250, 213, 255],
    [255, 156, 156], [99, 255, 0], [157, 225, 255], [255, 89, 124],
    [173, 255, 156], [255, 60, 0], [40, 0, 255], [170, 124, 0],
    [188, 255, 0], [0, 207, 255], [0, 255, 207], [188, 0, 255],
    [243, 0, 255], [0, 203, 108], [252, 255, 0], [93, 182, 177],
    [0, 81, 203], [211, 183, 120], [231, 203, 0], [0, 124, 255],
    [10, 91, 44], [2, 0, 60], [0, 144, 2], [133, 59, 59],
], dtype=np.uint8)


def task_colormap(task: int) -> np.ndarray:
    """(num_label_values, 3) uint8 colour table in *network* label space.

    Each task class takes the colour of its first canonical member; the
    ignore class (last index, tasks 2/3) renders black.
    Reference: utils/utils.py:50-64 (get_remapped_colormap).
    """
    n = num_label_values(task)
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for task_id, canon_ids in TASK_GROUPS[task].items():
        if task_id == IGNORE_VALUE:
            cmap[n - 1] = 0  # ignore renders black (utils/utils.py:60-61)
        else:
            cmap[task_id] = CADIS_COLORMAP[canon_ids[0]]
    return cmap
