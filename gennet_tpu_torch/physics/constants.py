"""Physical constants and detector geometry (a copy of
``gennet_tpu.physics.constants``, which the port must not import).

Replaces the reference's use of `lal.MSUN_SI`, `lal.PC_SI`, `lal.C_SI`,
`lal.G_SI` (ref: gw_template_maker.py:47,500,508) and
`lalsimulation.DetectorPrefixToLALDetector(...).location`
(ref: gw_template_maker.py:616). Values follow the LAL headers (CODATA/IAU).
"""

import math

# SI constants (LALConstants.h values)
C_SI = 299792458.0                      # speed of light [m/s]
G_SI = 6.67430e-11                      # Newton's constant [m^3 kg^-1 s^-2]
MSUN_SI = 1.988409902147041637325262574352366540e30   # solar mass [kg]
PC_SI = 3.085677581491367278913937957796471611e16     # parsec [m]
MPC_SI = 1e6 * PC_SI

# geometrized solar mass in seconds / meters
MTSUN_SI = G_SI * MSUN_SI / C_SI**3     # ~4.925491e-6 s
MRSUN_SI = G_SI * MSUN_SI / C_SI**2     # ~1476.625 m

GAMMA = 0.5772156649015328606065120900824024  # Euler-Mascheroni
PI = math.pi

# --- Strain unit scale ----------------------------------------------------
# The framework computes in float32; physical strain (~1e-21) is fine
# in f32 but strain *PSDs* (~1e-46) underflow it. All strain-carrying
# quantities therefore use scaled units of 1e-21 strain: waveforms carry
# strain × STRAIN_SCALE, PSDs carry psd × STRAIN_SCALE². Whitened series are
# scale-invariant, so the training pipeline never sees the convention; only
# code converting to/from physical strain must divide/multiply.
STRAIN_SCALE = 1e21

# Earth (WGS84-ish values used by LAL for sidereal time)
EARTH_EQUATORIAL_RADIUS_SI = 6378136.6
DAYSID_SI = 86164.09053                 # sidereal day [s]

# --- Detector geometry --------------------------------------------------
# Cartesian Earth-fixed vertex locations [m] and response tensors, as used by
# LALDetectors.h. The response tensor d = (x⊗x − y⊗y)/2 with x,y the arm
# direction unit vectors; stored explicitly so antenna_response is a pure
# tensor contraction (ref replacement for pylal.antenna.response,
# gw_template_maker.py:612).

DETECTORS = {
    "H1": {
        "location": (-2.16141492636e6, -3.83469517889e6, 4.60035022664e6),
        "xarm": (-0.22389266154, 0.79983062746, 0.55690487831),
        "yarm": (-0.91397818574, 0.02609403989, -0.40492342125),
    },
    "L1": {
        "location": (-7.42760447238e4, -5.49628371971e6, 3.22425701744e6),
        "xarm": (-0.95457412153, -0.14158077340, -0.26218911324),
        "yarm": (0.29774156894, -0.48791033647, -0.82054461286),
    },
    "V1": {
        "location": (4.54637409900e6, 8.42989697626e5, 4.37857696241e6),
        "xarm": (-0.70045821479, 0.20848948619, 0.68256166277),
        "yarm": (-0.05379255368, -0.96908180549, 0.24080451708),
    },
}


def detector_tensor(det: str):
    """Return the 3x3 detector response tensor d_ij for a named detector."""
    import numpy as np

    x = np.asarray(DETECTORS[det]["xarm"])
    y = np.asarray(DETECTORS[det]["yarm"])
    return 0.5 * (np.outer(x, x) - np.outer(y, y))


# GW150914 conventions used throughout the reference
GW150914_EVENT_TIME = 1126259462.0      # GPS (ref: gw_template_maker.py:62)
GW150914_FIXED_EXTRINSIC = {
    # ref: gw_template_maker.py:432-437 — all non-mass params pinned
    "ra": 2.21535724066,
    "dec": -1.23649695537,
    "iota": 2.5,
    "phi": 1.5,
    "psi": 1.75,
}
GW150914_TEMPLATE_MASSES = (36.0, 29.0)  # ref: gw_template_maker.py:447
DEFAULT_DISTANCE_MPC = 410.0             # ref: gw_template_maker.py:500
DEFAULT_F_LOW = 40.0                     # ref: gw_template_maker.py:495
