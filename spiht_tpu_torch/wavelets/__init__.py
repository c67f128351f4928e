from .filters import Wavelet, build_wavelet, wavelist, dwt_max_level, dwt_coeff_len
from .geometry import get_slices_and_h_w, slices_to_wire
