"""fastdem_tpu: a real-time 2.5D elevation-mapping framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of FastDEM
(github.com/Ikhyeon-Cho/FastDEM): LiDAR/RGB-D point-cloud ingestion with
physics-based sensor noise models, scatter-based rasterization into a dense
2.5D grid, recursive per-cell height estimation (Kalman / P2 quantile),
log-odds raycast ghost removal, and stencil post-processing (inpainting,
uncertainty fusion, terrain features, median smoothing) — plus a
block-sharded multi-host global-map mode the reference does not have.
"""

__version__ = "0.1.0"

from fastdem_tpu.config.config import (  # noqa: F401
    Config,
    EstimationType,
    MappingMode,
    PostProcessConfig,
    RasterMethod,
    SensorType,
    load_config,
    parse_config,
)
from fastdem_tpu.grid.geometry import GridGeometry  # noqa: F401
from fastdem_tpu.grid.gridmap import GridMapState, layers  # noqa: F401
from fastdem_tpu.mapping.pipeline import (  # noqa: F401
    FastDEM,
    build_integrate,
    build_integrate_sequence,
    create_map_state,
)

# Submodule conveniences (import cheaply; heavy deps load lazily inside).
from fastdem_tpu.grid import gridmap  # noqa: F401
from fastdem_tpu.io.npz import load_npz, save_npz  # noqa: F401
from fastdem_tpu.io.png import save_png  # noqa: F401
from fastdem_tpu.mapping.batch import DEMConfig, build_dem, to_pointcloud  # noqa: F401
from fastdem_tpu.runtime.driver import MappingDriver  # noqa: F401
from fastdem_tpu.runtime.node_config import NodeConfig  # noqa: F401
