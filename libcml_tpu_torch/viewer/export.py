"""Map/trajectory visualization by export: PLY point clouds, a trajectory
ribbon, and a self-contained HTML point-cloud viewer.

A copy of libcml_tpu/viewer/export.py for the port (host numpy only). It
replaces the reference's Qt/OpenGL GUI tier (reference:
src/cml/gui/MainSlamWidget.{h,cpp} — 3D model + camera viewers;
gui/drawboard/QtDrawBoard — GL point cloud straight from the Map's SoA slab
buffers Map.cpp:188-219): the GUI's jobs — inspect the map, inspect the
trajectory, dump frames — are served by exports viewable anywhere, fed from
the same host arrays the map already keeps.

The variance filter of the reference's viewer (VarianceViewer) maps to the
`max_uncertainty` argument: points above it are dropped from the export."""

from __future__ import annotations

import json
import os

import numpy as np


def export_ply(
    path: str,
    xyz: np.ndarray,
    color: np.ndarray | None = None,
    uncertainty: np.ndarray | None = None,
    max_uncertainty: float = np.inf,
) -> int:
    """Write a binary little-endian PLY of the point cloud. color: (N,) gray
    or (N, 3) rgb in [0, 255]. Returns the number of points written."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    keep = np.isfinite(xyz).all(axis=1)
    if uncertainty is not None:
        keep &= np.asarray(uncertainty).reshape(-1) <= max_uncertainty
    xyz = xyz[keep]
    if color is None:
        rgb = np.full((len(xyz), 3), 200, np.uint8)
    else:
        c = np.asarray(color)[keep]
        rgb = (
            np.clip(np.stack([c] * 3, -1) if c.ndim == 1 else c, 0, 255)
            .astype(np.uint8)
        )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(
            (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(xyz)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n"
            ).encode()
        )
        rec = np.zeros(
            len(xyz),
            dtype=np.dtype(
                [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                 ("r", "u1"), ("g", "u1"), ("b", "u1")],
            ),
        )
        rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        rec["r"], rec["g"], rec["b"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
        f.write(rec.tobytes())
    return len(xyz)


def export_trajectory_ply(path: str, poses_c2w: np.ndarray,
                          every: int = 1) -> int:
    """Camera centers as a colored polyline point cloud (blue -> red over
    time), the GUI's trajectory ribbon."""
    P = np.asarray(poses_c2w)[::every, :3, 3]
    t = np.linspace(0, 1, len(P))
    color = np.stack([255 * t, 64 * np.ones_like(t), 255 * (1 - t)], -1)
    return export_ply(path, P, color)


def export_html_viewer(
    path: str,
    xyz: np.ndarray,
    poses_c2w: np.ndarray | None = None,
    color: np.ndarray | None = None,
    max_points: int = 60000,
) -> str:
    """Self-contained HTML viewer (vanilla canvas, zero dependencies):
    orbiting point-cloud render with the trajectory overlaid — the
    ModelWidget 3D view without Qt."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    keep = np.isfinite(xyz).all(axis=1)
    xyz = xyz[keep]
    if len(xyz) > max_points:
        sel = np.linspace(0, len(xyz) - 1, max_points).astype(int)
        xyz = xyz[sel]
        color = None if color is None else np.asarray(color)[keep][sel]
    pts = xyz.round(4).tolist()
    traj = (
        np.asarray(poses_c2w)[:, :3, 3].round(4).tolist()
        if poses_c2w is not None else []
    )
    html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<style>body{{margin:0;background:#111}}canvas{{display:block}}</style></head>
<body><canvas id="c"></canvas><script>
const pts={json.dumps(pts)};const traj={json.dumps(traj)};
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=0.5,pitch=0.3,dist=8,cx=0,cy=0,cz=0,drag=0,lx=0,ly=0;
if(pts.length){{const m=[0,1,2].map(i=>pts.reduce((a,p)=>a+p[i],0)/pts.length);
cx=m[0];cy=m[1];cz=m[2];}}
function draw(){{cv.width=innerWidth;cv.height=innerHeight;
ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
const sy=Math.sin(yaw),cyw=Math.cos(yaw),sp=Math.sin(pitch),cp=Math.cos(pitch);
function proj(p){{let x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
let x1=cyw*x+sy*z,z1=-sy*x+cyw*z,y1=cp*y-sp*z1,z2=sp*y+cp*z1+dist;
if(z2<0.1)return null;const f=0.9*Math.min(cv.width,cv.height);
return [cv.width/2+f*x1/z2,cv.height/2+f*y1/z2,z2];}}
ctx.fillStyle='#9ec';for(const p of pts){{const q=proj(p);
if(q)ctx.fillRect(q[0],q[1],1.5,1.5);}}
ctx.strokeStyle='#f55';ctx.beginPath();let first=1;
for(const p of traj){{const q=proj(p);if(!q)continue;
first?ctx.moveTo(q[0],q[1]):ctx.lineTo(q[0],q[1]);first=0;}}ctx.stroke();}}
cv.onmousedown=e=>{{drag=1;lx=e.clientX;ly=e.clientY}};
cv.onmouseup=()=>drag=0;
cv.onmousemove=e=>{{if(!drag)return;yaw+=(e.clientX-lx)*0.01;
pitch+=(e.clientY-ly)*0.01;lx=e.clientX;ly=e.clientY;draw()}};
cv.onwheel=e=>{{dist*=Math.exp(e.deltaY*0.001);draw()}};
addEventListener('resize',draw);draw();
</script></body></html>"""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


def snapshot(odo, out_dir: str, name: str = "map") -> dict:
    """One-call export of a running odometry's state: map PLY + trajectory
    PLY + HTML viewer (the GUI's `-s` frame-dump analogue)."""
    os.makedirs(out_dir, exist_ok=True)
    ts, poses = odo.trajectory_c2w()
    files = {
        "trajectory": export_trajectory_ply(
            os.path.join(out_dir, f"{name}_traj.ply"), poses
        )
    }
    xyz = None
    if hasattr(odo, "_pt_valid") and odo._pt_valid.any():
        xyz = odo._pt_Xw[odo._pt_valid]
        files["points"] = export_ply(
            os.path.join(out_dir, f"{name}_points.ply"), xyz
        )
    export_html_viewer(
        os.path.join(out_dir, f"{name}.html"),
        xyz if xyz is not None else np.zeros((0, 3)),
        poses,
    )
    return files
