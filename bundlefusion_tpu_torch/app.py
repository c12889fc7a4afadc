"""Command-line application (port of ``bundlefusion_tpu.app``).

Takes an app config and a bundling config (JSON), picks an input source (a
``.sens`` file, a TUM directory or the synthetic generator), replays it
through the pipeline on ``--device`` (the card by default; there is no
fallback to the CPU), and writes the mesh, the trajectory, previews,
checkpoints and a summary:

    python -m bundlefusion_tpu_torch.app --sens scan.sens --out out/
    python -m bundlefusion_tpu_torch.app --tum rgbd_dataset_freiburg1_desk --out out/
    python -m bundlefusion_tpu_torch.app --synthetic 66 --out out/
    python -m bundlefusion_tpu_torch.app --synthetic 11 --device cpu --out out/
    python -m bundlefusion_tpu_torch.app --synthetic 66 --multiseq 2 --out out/
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BundleFusion on PyTorch")
    p.add_argument("--app-config", help="AppConfig JSON path")
    p.add_argument("--bundling-config", help="BundlingConfig JSON path")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--sens", help=".sens file to replay")
    src.add_argument("--tum", help="TUM sequence directory")
    src.add_argument("--synthetic", type=int, help="generate N synthetic frames")
    src.add_argument(
        "--input",
        help="input path; the reader is selected by the app config's sensor_idx, as the reference's "
        "getRGBDSensor(s_sensorIdx) does (8 = .sens recording, 7 = image-directory/TUM)",
    )
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--batch", type=int, default=8, help="replayer batch size")
    p.add_argument("--width", type=int, default=320, help="synthetic width")
    p.add_argument("--height", type=int, default=240, help="synthetic height")
    p.add_argument(
        "--multiseq", type=int, default=0,
        help="run N independent synthetic sequences data-parallel over an N-shard mesh on --device "
        "(shard i on card i modulo the card count; requires --synthetic)",
    )
    p.add_argument("--checkpoint-every", type=int, default=0, help="chunks between checkpoints (0=off)")
    p.add_argument("--preview-every", type=int, default=0, help="frames between preview images (0=off)")
    p.add_argument("--no-mesh", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from .bundle.checkpoint import save_checkpoint
    from .bundle.pipeline import BundleFusion
    from .config import Config
    from .eval.ate import ate_rmse
    from .io import ply
    from .io.replayer import Replayer, SensSource, SyntheticSource, TumSource
    from .visualization import save_preview

    cfg = Config.load(args.app_config, args.bundling_config)
    os.makedirs(args.out, exist_ok=True)

    if args.synthetic and not args.bundling_config:
        # the default 80x60 cache (for 640x480 sensors) rarely divides an
        # arbitrary synthetic size; derive a /4 cache instead
        cw, ch = max(args.width // 4, 8), max(args.height // 4, 8)
        cfg = Config(
            app=cfg.app,
            bundling=dataclasses.replace(cfg.bundling, cache_width=cw, cache_height=ch, verify_width=cw,
                                         verify_height=ch),
        )

    if args.input:
        # the config decides the reader; live-sensor indices (0-6) are not ported
        idx = cfg.app.sensor_idx
        if idx == 8:
            args.sens = args.input
        elif idx == 7:
            args.tum = args.input
        else:
            raise SystemExit(
                f"sensor_idx={idx} is a live-sensor index; only recorded inputs are supported "
                "(8 = .sens, 7 = image directory/TUM)"
            )

    if args.multiseq:
        if not args.synthetic:
            raise SystemExit("--multiseq requires --synthetic N")
        return _run_multiseq(args, cfg)

    gt_poses = None
    if args.sens:
        source = SensSource(args.sens)
        if np.isfinite(source.gt_poses).all():
            gt_poses = source.gt_poses
    elif args.tum:
        from .io.tum import load_tum_sequence

        seq = load_tum_sequence(args.tum)
        source = TumSource(seq)
        gt_poses = seq.gt_poses
    else:
        from .io.synthetic import generate_sequence

        seq = generate_sequence(args.synthetic, width=args.width, height=args.height, device=args.device)
        source = SyntheticSource(seq)
        gt_poses = seq.poses

    anchor = gt_poses[0] if gt_poses is not None else None
    rep = Replayer(source, batch_size=args.batch)
    bf = BundleFusion(rep.camera, cfg, log_path=os.path.join(args.out, "run.jsonl"), anchor_pose=anchor,
                      device=args.device)

    frame_idx = 0
    for batch in rep:
        for i in range(batch.depth.shape[0]):
            if not batch.valid[i]:
                continue
            bf.push_frame(batch.depth[i], batch.color[i])
            frame_idx += 1
            if args.preview_every and frame_idx % args.preview_every == 0:
                pose, valid = bf.current_poses()  # drains the ingest workers first
                if len(pose) and valid[-1]:
                    img = bf.render_preview(pose[-1])
                    save_preview(os.path.join(args.out, f"preview_{frame_idx:05d}.png"), img)
        if args.checkpoint_every:
            bf.sync()  # chunk_count lags under async ingest until drained
        if args.checkpoint_every and bf.chunk_count and bf.chunk_count % args.checkpoint_every == 0:
            save_checkpoint(bf, os.path.join(args.out, "checkpoint.pkl"))
    bf.flush()

    out = bf.outputs()
    np.save(os.path.join(args.out, "trajectory.npy"), out.poses)
    np.save(os.path.join(args.out, "trajectory_valid.npy"), out.valid)
    write_tum_trajectory(os.path.join(args.out, "trajectory.txt"), out.poses, out.valid)

    summary = {
        "frames": int(out.poses.shape[0]),
        "keyframes": out.num_keyframes,
        "tracking_lost_chunks": out.tracking_lost_chunks,
        "active_blocks": int(bf.state.table.num_active()),
        "timing": bf.timing.summary(),
    }
    if gt_poses is not None:
        n = min(len(out.poses), len(gt_poses))
        summary["ate_rmse_m"] = ate_rmse(out.poses[:n], gt_poses[:n], valid=out.valid[:n])
    if not args.no_mesh:
        verts, colors, faces = bf.extract_mesh()
        ply.write_ply(os.path.join(args.out, "mesh.ply"), verts, colors, faces)
        summary["mesh_triangles"] = int(len(faces))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


def _run_multiseq(args, cfg) -> int:
    """D synthetic sequences (seeds 0..D-1) data-parallel over a D-shard mesh."""
    from .eval.ate import ate_rmse
    from .io import ply
    from .io.synthetic import generate_sequence
    from .parallel.mesh import make_mesh
    from .parallel.spmd_pipeline import extract_mesh_for, run_sequences_sharded

    d = args.multiseq
    mesh = make_mesh(d, args.device)
    seqs = [
        generate_sequence(args.synthetic, width=args.width, height=args.height, seed=s, device=args.device)
        for s in range(d)
    ]
    out = run_sequences_sharded(seqs, mesh, cfg, anchor_poses=np.stack([s.poses[0] for s in seqs]))
    summary = {"sequences": d, "mesh": repr(mesh), "keyframes_per_seq": out.num_keyframes, "ate_rmse_m": {}}
    for i in range(d):
        n = min(out.poses.shape[1], len(seqs[i].poses))
        summary["ate_rmse_m"][i] = ate_rmse(out.poses[i, :n], seqs[i].poses[:n], valid=out.valid[i, :n])
        np.save(os.path.join(args.out, f"trajectory_{i}.npy"), out.poses[i])
    if not args.no_mesh:
        verts, colors, faces = extract_mesh_for(out, 0, cfg)
        ply.write_ply(os.path.join(args.out, "mesh_0.ply"), verts, colors, faces)
        summary["mesh_triangles"] = int(len(faces))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


def write_tum_trajectory(path: str, poses: np.ndarray, valid: np.ndarray) -> None:
    """TUM format: timestamp tx ty tz qx qy qz qw, valid frames only."""
    with open(path, "w") as f:
        for i, (T, ok) in enumerate(zip(poses, valid)):
            if not ok:
                continue
            t = T[:3, 3]
            q = _mat_to_quat(T[:3, :3])
            f.write(f"{i / 30.0:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = [0.0, 0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q[0], q[1], q[2], q[3]
    return np.array([x, y, z, w])


if __name__ == "__main__":
    raise SystemExit(main())
