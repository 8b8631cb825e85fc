"""Offline converters for the remaining reference corpus sources (the port's
copy of dpot_tpu/data/converters.py):
CFDBench, PDEArena, and SuperBench (reference data_generation/cfdbench/,
data_generation/preprocess.py:276-546, data_generation/pdearena/ and
data_generation/superbench/preprocess.py).

All converters are pure numpy/h5py (no torch) and write the framework's
HDF5 protocol (see data/generation.py). The reference's torch
Dataset wrappers around CFDBench (per-frame pair sampling with convergence
trimming) are deliberately not ported: the only consumer in the DPOT
pipeline is save_data.py, which reads the untrimmed per-case feature
stacks — that path is what `convert_cfdbench` reproduces.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

from dpot_tpu_torch.data.resize import resize_linear_nd

# ---------------------------------------------------------------------------
# CFDBench (reference data_generation/cfdbench/{cavity,cylinder,dam,tube}.py)
# ---------------------------------------------------------------------------


def normalize_physics_props(case_params: Dict[str, float]) -> None:
    """In-place z-normalization of density/viscosity with the reference's
    fixed corpus statistics (cfdbench/utils.py:8-19).

    NOTE: the shipped converters write fields-only corpora (exactly what
    the reference's preprocess emits), so case_params — and hence this
    helper and normalize_bc — never affect the written data; they are
    API-parity ports for consumers that DO read case_params."""
    case_params["density"] = (case_params["density"] - 5) / 4
    case_params["viscosity"] = (case_params["viscosity"] - 0.00238) / 0.005


def normalize_bc(case_params: Dict[str, float], key: str) -> None:
    """In-place boundary-condition scaling (cfdbench/utils.py:22-26)."""
    case_params[key] = case_params[key] / 50 - 0.5


def load_cfdbench_case(
    case_dir: str, problem: str
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Load one CFDBench case dir ({u,v}.npy + case.json) into the padded
    (T, 3, h, w) feature stack [u, v, mask], per-problem boundary handling:

    - cavity: no padding, all-ones mask (cavity.py:15-33);
    - tube: left edge = vel_in inflow, walls top/bottom (tube.py:15-48);
    - cylinder: tube padding + circular obstacle zeroed in the mask
      (cylinder.py:15-72);
    - dam: left inflow below barrier_top, barrier zeroed in the mask
      (dam.py:44-101).
    """
    with open(os.path.join(case_dir, "case.json"), encoding="utf8") as f:
        case_params = json.load(f)
    u = np.load(os.path.join(case_dir, "u.npy"))
    v = np.load(os.path.join(case_dir, "v.npy"))
    mask = np.ones_like(u)

    if problem == "cavity":
        pass  # interior-only fields, all-ones mask
    elif problem in ("tube", "cylinder"):
        if problem == "cylinder":
            x_min, x_max = case_params["x_min"], case_params["x_max"]
            y_min, y_max = case_params["y_min"], case_params["y_max"]
            radius = case_params["radius"]
            case_params["center_x"] = -x_min
            case_params["center_y"] = -y_min
            for key in ("x_min", "x_max", "y_min", "y_max"):
                del case_params[key]
            case_params["height"] = y_max - y_min
            case_params["width"] = x_max - x_min
            dx = case_params["width"] / u.shape[2]
            dy = case_params["height"] / u.shape[1]
            # vectorized form of the reference's per-pixel loop
            # (cylinder.py:50-56)
            xs = x_min + np.arange(u.shape[2]) * dx
            ys = y_min + np.arange(u.shape[1]) * dy
            inside = (
                (xs[None, :] - 0.5) ** 2 + (ys[:, None] - 0.5) ** 2
            ) <= radius**2
            mask[:, inside] = 0
        u = np.pad(u, ((0, 0), (0, 0), (1, 0)), mode="constant",
                   constant_values=case_params["vel_in"])
        v = np.pad(v, ((0, 0), (0, 0), (1, 0)), mode="constant")
        mask = np.pad(mask, ((0, 0), (0, 0), (1, 0)), mode="constant")
        u = np.pad(u, ((0, 0), (1, 1), (0, 0)), mode="constant")
        v = np.pad(v, ((0, 0), (1, 1), (0, 0)), mode="constant")
        mask = np.pad(mask, ((0, 0), (1, 1), (0, 0)), mode="constant")
    elif problem == "dam":
        barrier_top_idx = int(case_params["barrier_height"] / case_params["dy"])
        barrier_left_idx = int(0.5 / case_params["dx"])
        barrier_right_idx = int(
            (0.5 + case_params["barrier_width"]) / case_params["dx"]
        )
        # NOTE: preserved reference quirk (dam.py:75): the intended
        # mask[:, bottom:top, left:right] = 0 is written with a slice
        # step, so it zeroes nothing in practice
        mask[:0:barrier_top_idx, barrier_left_idx:barrier_right_idx] = 0
        u = np.pad(u, ((0, 0), (0, 0), (1, 0)), mode="constant")
        u[:, :barrier_top_idx, :1] = case_params["velocity"]
        v = np.pad(v, ((0, 0), (0, 0), (1, 0)), mode="constant")
        mask = np.pad(mask, ((0, 0), (0, 0), (1, 0)), mode="constant")
        u = np.pad(u, ((0, 0), (1, 1), (0, 0)), mode="constant")
        v = np.pad(v, ((0, 0), (1, 1), (0, 0)), mode="constant")
        mask = np.pad(mask, ((0, 0), (1, 1), (0, 0)), mode="constant")
        case_params = {
            k: case_params[k]
            for k in ("velocity", "density", "viscosity", "height", "width")
        }
    else:
        raise ValueError(f"unknown CFDBench problem {problem!r}")
    return np.stack([u, v, mask], axis=1), case_params


def cfdbench_case_split(
    problem_dir: str, subsets: Sequence[str] = ("prop", "bc", "geo"),
    seed: int = 0, rounding: str = "round",
) -> Tuple[List[str], List[str], List[str]]:
    """Reproduce the reference's case split: gather case dirs from the
    requested subsets in sorted-numeric order, seed-0 shuffle, 80/10/10.

    Preserved reference quirk: the cavity auto-dataset sizes splits with
    round() (cavity.py:404-405) but tube/dam/cylinder use int() truncation
    (tube.py:338, dam.py:366, cylinder.py:406-407) — `rounding` selects
    which, so converted splits are byte-identical to the reference's."""
    import glob

    case_dirs: List[str] = []
    for name in ("prop", "bc", "geo"):
        if name in subsets:
            found = glob.glob(os.path.join(problem_dir, name, "case*"))
            case_dirs += sorted(found, key=lambda p: int(os.path.basename(p)[4:]))
    rng = random.Random(seed)
    rng.shuffle(case_dirs)
    n = len(case_dirs)
    sizer = round if rounding == "round" else int
    n_train = sizer(n * 0.8)
    n_dev = sizer(n * 0.1)
    return (
        case_dirs[:n_train],
        case_dirs[n_train : n_train + n_dev],
        case_dirs[n_train + n_dev :],
    )


def split_trajectory(
    data_list: Sequence[np.ndarray], time_step: int, grid_size: int = 64
) -> np.ndarray:
    """Pad each (T, C, h, w) trajectory to a multiple of `time_step` with
    its last frame, bilinearly resize (align_corners=True) to
    grid_size^2, and reshape into (num_segments, time_step, C, g, g)
    segments — port of preprocess.py:477-502 / cfdbench/save_data.py:65-88.
    """
    out = []
    for x in data_list:
        T = x.shape[0]
        num_segments = -(-T // time_step)
        padded = np.zeros((num_segments * time_step, *x.shape[1:]), x.dtype)
        padded[:T] = x
        if T % time_step != 0:
            padded[T:] = x[-1]
        # (T', C, h, w) -> resize (h, w); resize_linear_nd works on leading
        # axes, so move the spatial axes first
        moved = np.moveaxis(padded, (2, 3), (0, 1))  # (h, w, T', C)
        resized = resize_linear_nd(
            moved, (grid_size, grid_size), align_corners=True
        )
        resized = np.moveaxis(resized, (0, 1), (2, 3))  # (T', C, g, g)
        out.append(
            resized.reshape(num_segments, time_step, *resized.shape[1:])
        )
    return np.concatenate(out, axis=0)


def convert_cfdbench(
    data_dir: str,
    dst_train: str,
    dst_test: str,
    problems: Sequence[str] = ("cavity", "cylinder", "tube"),
    subsets: Sequence[str] = ("prop", "bc", "geo"),
    infer_steps: int = 20,
    grid_size: int = 64,
) -> Tuple[int, int]:
    """Full CFDBench -> ns2d_cdb_{train,test}.hdf5 pipeline (reference
    preprocess_cfdbench_data, preprocess.py:425-546 + save_data.py).

    Per problem: split cases 80/10/10 (dev unused, like the reference),
    load the padded per-case feature stacks, segment + downscale to
    grid_size^2 x infer_steps windows, write single-file datasets shaped
    (B, X, Y, T, C). Returns (n_train, n_test) sample counts."""
    import h5py

    train_feats: List[np.ndarray] = []
    test_feats: List[np.ndarray] = []
    for problem in problems:
        tr, _, te = cfdbench_case_split(
            os.path.join(data_dir, problem), subsets,
            rounding="round" if problem == "cavity" else "int",
        )
        train_feats += [load_cfdbench_case(d, problem)[0] for d in tr]
        test_feats += [load_cfdbench_case(d, problem)[0] for d in te]

    train = split_trajectory(train_feats, infer_steps, grid_size)
    test = split_trajectory(test_feats, infer_steps, grid_size)
    # (B, T, C, g, g) -> (B, X, Y, T, C)  (preprocess.py:506)
    train = train.transpose(0, 3, 4, 1, 2).astype(np.float32)
    test = test.transpose(0, 3, 4, 1, 2).astype(np.float32)

    for path, data in ((dst_train, train), (dst_test, test)):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=data, compression=None)
    return train.shape[0], test.shape[0]


# ---------------------------------------------------------------------------
# PDEArena (reference preprocess.py:276-420, data_generation/pdearena/)
# ---------------------------------------------------------------------------


def convert_pdearena_ns2d(load_path: str, save_path: str) -> Tuple[int, int]:
    """PDEArena NavierStokes-2D (.h5 shards with {split}/{u,vx,vy}) ->
    scatter protocol (preprocess.py:276-334). 'valid' shards join train,
    matching the reference. Returns (n_train, n_test)."""
    import h5py

    test_dir = os.path.join(save_path, "test")
    train_dir = os.path.join(save_path, "train")
    os.makedirs(test_dir, exist_ok=True)
    os.makedirs(train_dir, exist_ok=True)

    test_tot = train_tot = 0
    for root, _, files in os.walk(load_path):
        for file in sorted(files):
            if not file.endswith(".h5"):
                continue
            with h5py.File(os.path.join(root, file), "r") as f:
                if "test" in file:
                    key, path = "test", test_dir
                elif "train" in file:
                    key, path = "train", train_dir
                elif "valid" in file:
                    key, path = "valid", train_dir
                else:
                    raise ValueError(f"unknown file type {file}")
                u = f[key]["u"][:]
                vx = f[key]["vx"][:]
                vy = f[key]["vy"][:]
            out = np.stack([u, vx, vy], axis=-1)  # (N, T, X, Y, 3)
            out = np.transpose(out, (0, 2, 3, 1, 4))  # (N, X, Y, T, 3)
            for data in out:
                if key == "test":
                    idx, test_tot = test_tot, test_tot + 1
                else:
                    idx, train_tot = train_tot, train_tot + 1
                with h5py.File(
                    os.path.join(path, f"data_{idx}.hdf5"), "w"
                ) as g:
                    g.create_dataset("data", data=data.astype(np.float32))
    return train_tot, test_tot


def convert_pdearena_shallow_water(
    load_path: str, save_path: str
) -> Tuple[int, int]:
    """PDEArena ShallowWater-2D (.nc per trajectory, fields u/v/div/vor at
    level 0 + pres) -> scatter protocol (preprocess.py:352-420). The split
    comes from the directory name; one file = one trajectory, stored as
    (X, Y, T, 5)."""
    import h5py

    test_dir = os.path.join(save_path, "test")
    train_dir = os.path.join(save_path, "train")
    os.makedirs(test_dir, exist_ok=True)
    os.makedirs(train_dir, exist_ok=True)

    test_tot = train_tot = 0
    for root, _, files in os.walk(load_path):
        for file in sorted(files):
            if not file.endswith(".nc"):
                continue
            with h5py.File(os.path.join(root, file), "r") as f:
                if "test" in root:
                    is_test = True
                elif "train" in root or "valid" in root:
                    is_test = False
                else:
                    raise ValueError(f"unknown split for {root}")
                u = f["u"][:][:, 0]
                v = f["v"][:][:, 0]
                div = f["div"][:][:, 0]
                vor = f["vor"][:][:, 0]
                pres = f["pres"][:]
            data = np.stack([u, v, div, vor, pres], axis=-1)  # (T, X, Y, 5)
            data = np.transpose(data, (1, 2, 0, 3))  # (X, Y, T, 5)
            if is_test:
                idx, test_tot, path = test_tot, test_tot + 1, test_dir
            else:
                idx, train_tot, path = train_tot, train_tot + 1, train_dir
            with h5py.File(os.path.join(path, f"data_{idx}.hdf5"), "w") as g:
                g.create_dataset("data", data=data.astype(np.float32))
    return train_tot, test_tot


# ---------------------------------------------------------------------------
# SuperBench (reference data_generation/superbench/preprocess.py)
# ---------------------------------------------------------------------------


def superbench_slice_and_permute(
    src_path: str, dst_path: str, time_steps: int = 50
) -> int:
    """Slice a (T, C, H, W) sequence into windows of `time_steps` with
    stride time_steps//2 (plus one final window flush against the end) and
    store as (N, H, W, time_steps, C) under 'data'
    (superbench/preprocess.py:63-99). Returns N."""
    import h5py

    with h5py.File(src_path, "r") as src:
        key = next(iter(src.keys()))
        data = src[key]
        T = data.shape[0]
        step = time_steps // 2
        starts = []
        s = 0
        while s + time_steps <= T:
            starts.append(s)
            s += step
        # the reference's tail flush: after the strided loop, anything left
        # before T gets one final window anchored at the end
        extra = s < T
        n = len(starts) + (1 if extra else 0)
        with h5py.File(dst_path, "w") as dst:
            shape_ = data.shape
            out = dst.create_dataset(
                "data", (n, shape_[2], shape_[3], time_steps, shape_[1]),
                dtype=data.dtype,
            )
            for i, st in enumerate(starts):
                out[i] = data[st : st + time_steps].transpose(2, 3, 0, 1)
            if extra:
                out[-1] = data[-time_steps:].transpose(2, 3, 0, 1)
    return n


def superbench_concat(src_paths: Sequence[str], dst_path: str) -> None:
    """Concatenate same-shape single-dataset .h5 files along axis 0
    (superbench/preprocess.py:25-50)."""
    import h5py

    srcs = []
    handles = []
    for p in src_paths:
        h = h5py.File(p, "r")
        handles.append(h)
        for key in h.keys():
            srcs.append(h[key])
    try:
        total = sum(d.shape[0] for d in srcs)
        with h5py.File(dst_path, "w") as dst:
            s = srcs[0].shape
            out = dst.create_dataset(
                "data", (total, s[1], s[2], s[3]), dtype=srcs[0].dtype
            )
            start = 0
            for d in srcs:
                out[start : start + d.shape[0]] = d
                start += d.shape[0]
    finally:
        for h in handles:
            h.close()


def convert_superbench(
    src_folder: str, dst_folder: str, time_steps: int = 50
) -> List[str]:
    """Walk a SuperBench corpus: same-shape sibling .h5 files are
    concatenated first, then every sequence is sliced into
    (N, H, W, time_steps, C) windows (superbench/preprocess.py:102-176).
    Returns the list of written files."""
    import h5py

    written: List[str] = []
    for root, _, files in os.walk(src_folder):
        h5_files = sorted(f for f in files if f.endswith(".h5"))
        if not h5_files:
            continue

        def shape_of(name):
            with h5py.File(os.path.join(root, name), "r") as f:
                return f[next(iter(f.keys()))].shape

        rel = os.path.relpath(root, src_folder)
        out_root = os.path.join(dst_folder, rel) if rel != "." else dst_folder
        os.makedirs(out_root, exist_ok=True)

        if len(h5_files) > 1 and len({shape_of(f) for f in h5_files}) == 1:
            dst = os.path.join(
                out_root,
                "_".join(f.replace(".h5", "") for f in h5_files) + ".hdf5",
            )
            tmp = dst.replace(".hdf5", "_tmp.hdf5")
            superbench_concat(
                [os.path.join(root, f) for f in h5_files], tmp
            )
            superbench_slice_and_permute(tmp, dst, time_steps)
            os.remove(tmp)
            written.append(dst)
            continue
        for f in h5_files:
            dst = os.path.join(out_root, f.replace(".h5", ".hdf5"))
            superbench_slice_and_permute(
                os.path.join(root, f), dst, time_steps
            )
            written.append(dst)
    return written
