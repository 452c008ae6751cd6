from .coords_compare import coord_compare, mse_6d
from .tmscore import kabsch, run_tmalign, tm_score
