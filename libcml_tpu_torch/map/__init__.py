"""Global map layer: frame/point tables, group bitmasks, covisibility,
deform-graph trajectory, export (reference: src/cml/map/)."""

from libcml_tpu_torch.map.map import Groups, SlamMap  # noqa: F401
