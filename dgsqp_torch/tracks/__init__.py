from dgsqp_torch.tracks.base import RadiusArclengthTrack
from dgsqp_torch.tracks.track_lib import (ChicaneTrack, CurveTrack, StraightTrack,
                                          get_available_tracks, get_track,
                                          load_mpclab_raceline, load_tum_raceline)
