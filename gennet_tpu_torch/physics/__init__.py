"""GW signal physics (port of ``gennet_tpu.physics``): PhenomD and
TaylorF2, PSDs, whitening, noise, SNR, detector geometry, mass and burst
priors. The exports mirror ``gennet_tpu.physics``'s."""

from gennet_tpu_torch.physics import constants
from gennet_tpu_torch.physics.burst import sample_burst_params, sine_gaussian
from gennet_tpu_torch.physics.detector import (antenna_response, fd_time_shift,
                                               fd_time_shift_phase, time_delay_from_earth_center)
from gennet_tpu_torch.physics.noise import colored_noise, white_noise
from gennet_tpu_torch.physics.priors import chirp_mass_eta, mc_q_to_m1m2, sample_masses
from gennet_tpu_torch.physics.psd import analytic_advligo_psd, regularize_psd
from gennet_tpu_torch.physics.waveform import (imrphenomd_ampphase, imrphenomd_htilde,
                                               taylorf2_htilde)
from gennet_tpu_torch.physics.whiten import whiten_fd, whiten_td, whitening_gain
from gennet_tpu_torch.physics.windows import tukey

__all__ = [
    "constants",
    "tukey",
    "whiten_fd",
    "whiten_td",
    "whitening_gain",
    "fd_time_shift_phase",
    "imrphenomd_ampphase",
    "colored_noise",
    "white_noise",
    "analytic_advligo_psd",
    "regularize_psd",
    "sine_gaussian",
    "sample_burst_params",
    "sample_masses",
    "chirp_mass_eta",
    "mc_q_to_m1m2",
    "antenna_response",
    "time_delay_from_earth_center",
    "fd_time_shift",
    "imrphenomd_htilde",
    "taylorf2_htilde",
]
