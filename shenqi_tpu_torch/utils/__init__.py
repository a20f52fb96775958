from .units import UnitSystem, get_unitsystem
from . import constants
