from libcml_tpu_torch.viewer.export import (
    export_ply,
    export_trajectory_ply,
    export_html_viewer,
    snapshot,
)

__all__ = [
    "export_ply", "export_trajectory_ply", "export_html_viewer", "snapshot",
]
