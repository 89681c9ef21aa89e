from .pipeline import (
    ClipEncoder,
    DeviceClipEncoder,
    ImageNetViTEncoder,
    RandomProjectionEncoder,
    SyntheticImageSource,
    build_feature_files,
    dump_depth_features,
    dump_raw_view_images,
)

__all__ = [
    "build_feature_files",
    "SyntheticImageSource",
    "RandomProjectionEncoder",
    "ClipEncoder",
    "ImageNetViTEncoder",
    "DeviceClipEncoder",
    "dump_raw_view_images",
    "dump_depth_features",
]
