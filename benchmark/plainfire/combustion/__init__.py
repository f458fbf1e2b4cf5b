from .edm import EddyDissipationModel
