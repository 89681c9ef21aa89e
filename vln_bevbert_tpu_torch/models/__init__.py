"""PyTorch model library mirroring vln_bevbert_tpu/models."""

from .bert import BertEmbeddings, BertLayer, BertXLayer, MlmHead, PanoEncoderLayer
from .clip import ClipVisionTower
from .depth_encoder import DdppoDepthEncoder, load_ddppo_ckpt
from .encoders import GlobalMapEncoder, ImageEmbeddings, LanguageEncoder, LocalBEVEncoder
from .glocal import GlocalTextPathCMT, GlocalTextPathCMTPreTraining
from .legacy import RecurrentVLNBert, prevalent_to_tree
from .nav import Critic, GlocalTextPathNavCMT

__all__ = [
    "BertEmbeddings",
    "BertLayer",
    "BertXLayer",
    "MlmHead",
    "PanoEncoderLayer",
    "LanguageEncoder",
    "ImageEmbeddings",
    "GlobalMapEncoder",
    "LocalBEVEncoder",
    "GlocalTextPathCMT",
    "GlocalTextPathCMTPreTraining",
    "GlocalTextPathNavCMT",
    "Critic",
    "ClipVisionTower",
    "DdppoDepthEncoder",
    "load_ddppo_ckpt",
    "RecurrentVLNBert",
    "prevalent_to_tree",
]
