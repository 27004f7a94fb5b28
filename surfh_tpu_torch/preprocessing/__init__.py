"""Real-data preprocessing: FITS I/O, distortion correction, Shepard
re-interpolation (torch, on a device), spectral median filtering, header
metadata, s3d cube ingestion.  Counterpart of `surfh_tpu/preprocessing/`."""

from .distortion import (
    generate_label_image,
    median_filter_slices,
    mrs_slices_distortion_correction,
    sort_labels_by_centroid,
)
from .fits_io import fits_open, fits_write
from .metadata import (
    header_geometry,
    mean_slit_world_coords,
    parse_raw_name,
    propagate_rotation,
    propagate_target_coords,
    rank_files_by_target_distance,
    swap_slit_blocks,
    swap_slit_blocks_in_files,
)
from .s3d import nan_border, oversample_plane_cloud, read_s3d, resample_cube_to_grid
from .shepard import exponential_modified_shepard

__all__ = [
    "exponential_modified_shepard",
    "fits_open",
    "fits_write",
    "generate_label_image",
    "header_geometry",
    "mean_slit_world_coords",
    "median_filter_slices",
    "mrs_slices_distortion_correction",
    "nan_border",
    "oversample_plane_cloud",
    "parse_raw_name",
    "propagate_rotation",
    "propagate_target_coords",
    "rank_files_by_target_distance",
    "read_s3d",
    "resample_cube_to_grid",
    "sort_labels_by_centroid",
    "swap_slit_blocks",
    "swap_slit_blocks_in_files",
]
