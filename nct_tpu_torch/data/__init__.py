"""Image codecs, the prefetching pair loader and the data sources of the
training path (counterpart of ``nct_tpu.data``).

Host-IO data-source layer types (the BasePrefetchingDataLayer family):
``NetSolver`` strips these from the net and streams their tops as per-step
batches.  ``make_data_source`` maps a layer's prototxt ``type`` to a
source with ``next_batch(part=None) -> tuple of arrays`` (images NCHW;
``part = (i, n)``: the i-th of n row blocks, for one data rank),
``state()`` (its position as {name: array}) and ``set_state(state)``.
"""

from nct_tpu_torch.data.loader import PairLoader

__all__ = ["PairLoader", "DATA_LAYER_TYPES", "make_data_source"]

DATA_LAYER_TYPES = ("ImageData", "HDF5Data", "Data", "WindowData",
                    "MemoryData")


def make_data_source(layer_cfg: dict, phase: str = "TRAIN", seed: int = 0):
    """The source of one data layer (the reference's layer factory
    restricted to its data layers): ImageData (image_data_layer.cpp),
    HDF5Data (hdf5_data_layer.cpp), Data -- record shards, LMDB or LevelDB
    (data_layer.cpp + util/db_*.cpp) -- WindowData (window_data_layer.cpp)
    and MemoryData (memory_data_layer.cpp)."""
    ltype = str(layer_cfg.get("type"))
    if ltype == "ImageData":
        from nct_tpu_torch.data.image_data import ImageDataSource

        return ImageDataSource(layer_cfg, phase=phase, seed=seed)
    if ltype == "HDF5Data":
        from nct_tpu_torch.data.hdf5_data import HDF5DataSource

        return HDF5DataSource(layer_cfg, phase=phase, seed=seed)
    if ltype == "Data":
        from nct_tpu_torch.data.records import RecordShardSource

        return RecordShardSource(layer_cfg, phase=phase, seed=seed)
    if ltype == "WindowData":
        from nct_tpu_torch.data.window_data import WindowDataSource

        return WindowDataSource(layer_cfg, phase=phase, seed=seed)
    if ltype == "MemoryData":
        from nct_tpu_torch.data.memory_data import MemoryDataSource

        return MemoryDataSource(layer_cfg, phase=phase, seed=seed)
    raise ValueError(f"not a data layer type: {ltype}")
