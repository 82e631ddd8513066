"""Offline scene preparation (counterpart of nerfloc_tpu/preprocess/): the
7-Scenes, 12-Scenes, OnePose and Cambridge preprocessors write each
scene's `info_{train,test}.pkl` (file_name, depth_file_name,
extrinsic_Tcw, camera_intrinsic, near/far, sequence/frame ids) and
`pc.ply`, which data/scene_store.py reads. Frames are read with the port's
own decoders (data/reader.py); TSDF fusion integrates on the card through
the kernel of native/tsdf.py unless the caller asks for the CPU.
"""
from .common import frame_near_far, fuse_scene_tsdf, load_pose_txt, make_meta, write_info

__all__ = ["frame_near_far", "fuse_scene_tsdf", "load_pose_txt", "make_meta", "write_info"]
