from dgsqp_torch.tracks.base import RadiusArclengthTrack
from dgsqp_torch.tracks.track_lib import StraightTrack, CurveTrack, ChicaneTrack
