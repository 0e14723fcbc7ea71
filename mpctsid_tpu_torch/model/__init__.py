from mpctsid_tpu_torch.model.solo12 import Solo12Model, SOLO12
from mpctsid_tpu_torch.model.gaits import GaitDef, TROT, WALK, BOUND, STATIC, GAITS

__all__ = ["Solo12Model", "SOLO12", "GaitDef", "TROT", "WALK", "BOUND", "STATIC", "GAITS"]
