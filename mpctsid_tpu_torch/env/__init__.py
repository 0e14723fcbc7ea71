from mpctsid_tpu_torch.env.interface import Plant, Sensors, SimPlant
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState, plant_step

__all__ = ["ContactParams", "PlantState", "plant_step", "Plant", "Sensors",
           "SimPlant"]
