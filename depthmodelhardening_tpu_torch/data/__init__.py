from .kitti_raw import KittiRawDataset, collate, load_split  # noqa: F401
from .kitti_object import KittiObjectScenes, seperate_sets  # noqa: F401
from .loader import PrefetchLoader  # noqa: F401
