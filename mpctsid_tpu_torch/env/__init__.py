from mpctsid_tpu_torch.env.plant import ContactParams, PlantState, plant_step

__all__ = ["ContactParams", "PlantState", "plant_step"]
