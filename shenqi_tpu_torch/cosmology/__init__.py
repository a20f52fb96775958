from .background import Cosmology
from .neutrinos import OmegaNu
