"""IMRPhenomD (aligned-spin, nonprecessing) in PyTorch, batched over masses.

Port of ``gennet_tpu.physics.waveform.imrphenomd_ampphase`` (Husa et al. /
Khan et al., arXiv:1508.07250 and arXiv:1508.07253): TaylorF2 inspiral
phase plus fitted sigma terms, beta intermediate and alpha merger-ringdown
phase ansätze stitched C(1), and the three-region amplitude model.

Where the JAX version is scalar per template and vmapped, this one takes
mass tensors of shape (B,) and keeps every per-template constant at shape
(B, 1), so it broadcasts against the (K,) frequency grid into (B, K). The
order of operations follows the reference so that float32 rounding stays
close to it; scalar break frequencies (Mf = 0.018, 0.014) stay Python
floats where the reference keeps them Python floats.
"""

import math

import numpy as np
import torch

from gennet_tpu_torch.physics import constants

PI = np.pi
GAMMA = constants.GAMMA

# Phenomenological coefficient fits (Khan et al. 2016, Table V):
#   λ(η, χPN) = λ00 + λ10 η + ξ (λ01 + λ11 η + λ21 η²)
#             + ξ² (λ02 + λ12 η + λ22 η²) + ξ³ (λ03 + λ13 η + λ23 η²),  ξ = χPN − 1
# Rows: [λ00, λ10, λ01, λ11, λ21, λ02, λ12, λ22, λ03, λ13, λ23]
_FITS = {
    "rho1": [3931.8979897196696, -17395.758706812805,
             3132.375545898835, 343965.86092361377, -1.2162565819981997e6,
             -70698.00600428853, 1.383907177859705e6, -3.9662761890979446e6,
             -60017.52423652596, 803515.1181825735, -2.091710365941658e6],
    "rho2": [-40105.47653771657, 112253.0169706701,
             23561.696065836168, -3.476180699403351e6, 1.137593670849482e7,
             754313.1127166454, -1.308476044625268e7, 3.6444584853928134e7,
             596226.612472288, -7.4277901143564405e6, 1.8928977514040343e7],
    "rho3": [83208.35471266537, -191237.7264145924,
             -210916.2454782992, 8.71797508352568e6, -2.6914942420669552e7,
             -1.9889806527362722e6, 3.0888029960154563e7, -8.390870279256162e7,
             -1.4535031953446497e6, 1.7063528990822166e7, -4.2748659731120914e7],
    "v2": [0.8149838730507785, 2.5747553517454658,
           1.1610198035496786, -2.3627771785551537, 6.771038707057573,
           0.7570782938606834, -2.7256896890432474, 7.1140380397149965,
           0.1766934149293479, -0.7978690983168183, 2.1162391502005153],
    "gamma1": [0.006927402739328343, 0.03020474290328981,
               0.006308024337706171, -0.12074130661131138, 0.26271598905781324,
               0.0034151773647198794, -0.10779338611188374, 0.27098966966891747,
               0.0007374185938559283, -0.02749621038376281, 0.0733150789135702],
    "gamma2": [1.010344404799477, 0.0008993122007234548,
               0.283949116804459, -4.049752962958005, 13.207828172665366,
               0.10396278486805426, -7.025059158961947, 24.784892370130475,
               0.03093202475605892, -2.6924023896851663, 9.609374464684983],
    "gamma3": [1.3081615607036106, -0.005537729694807678,
               -0.06782917938621007, -0.6689834970767117, 3.403147966134083,
               -0.05296577374411866, -0.9923793203111362, 4.820681208409587,
               -0.006134139870393713, -0.38429253308696365, 1.7561754421985984],
    "sigma1": [2096.551999295543, 1463.7493168261553,
               1312.5493286098522, 18307.330017082117, -43534.1440746107,
               -833.2889543511114, 32047.31997183187, -108609.45037520859,
               452.25136398112204, 8353.439546391714, -44531.3250037322],
    "sigma2": [-10114.056472621156, -44631.01109458185,
               -6541.308761668722, -266959.23419307504, 686328.3229317984,
               3405.6372187679685, -437507.7208209015, 1.6318171307344697e6,
               -7462.648563007646, -114585.25177153319, 674402.4689098676],
    "sigma3": [22933.658273436497, 230960.00814979506,
               14961.083974183695, 1.1940181342318142e6, -3.1042239693052764e6,
               -3038.166617199259, 1.8720322849093592e6, -7.309145012085539e6,
               42738.22871475411, 467502.018616601, -3.064853498512499e6],
    "sigma4": [-14621.71522218357, -377812.8579387104,
               -9608.682631509726, -1.7108925257214056e6, 4.332924601416521e6,
               -22366.683262266528, -2.5019716386377467e6, 1.0274495902259542e7,
               -85360.30079034246, -570025.3441737515, 4.396844346849777e6],
    "beta1": [97.89747327985583, -42.659730877489224,
              153.48421037904913, -1417.0620760768954, 2752.8614143665027,
              138.7406469558649, -1433.6585075135881, 2857.7418952430758,
              41.025109467376126, -423.680737974639, 850.3594335657173],
    "beta2": [-3.282701958759534, -9.051384468245866,
              -12.415449742258042, 55.4716447709787, -106.05109938966335,
              -11.953044553690658, 76.80704618365418, -155.33172948098394,
              -3.4129261592393263, 25.572377569952536, -54.408036707740465],
    "beta3": [-2.5156429818799565e-5, 1.9750256942201327e-5,
              -1.8370671469295915e-5, 2.1886317041311973e-5, 8.250240316860033e-5,
              7.157371250566708e-6, -5.5780000112270685e-5, 1.9142082884072178e-4,
              5.447166261464217e-6, -3.220610095021982e-5, 7.974016714984341e-5],
    "alpha1": [43.31514709695348, 638.6332679188081,
               -32.85768747216059, 2415.8938269370315, -5766.875169379177,
               -61.85459307173841, 2953.967762459948, -8986.29057591497,
               -21.571435779762044, 981.2158224673428, -3239.5664895930286],
    "alpha2": [-0.07020209449091723, -0.16269798450687084,
               -0.1872514685185499, 1.138313650449945, -2.8334196304430046,
               -0.17137955686840617, 1.7197549338119527, -4.539717148261272,
               -0.049983437357548705, 0.6062072055948309, -1.682769616644546],
    "alpha3": [9.5988072383479, -397.05438595557433,
               16.202126189517813, -1574.8286986717037, 3600.3410843831093,
               27.092429659075467, -1786.482357315139, 5152.919378666511,
               11.175710130033895, -577.7999423177481, 1808.730762932043],
    "alpha4": [-0.02989487384493607, 1.4022106448583738,
               -0.07356049468633846, 0.8337006542278661, 0.2240008282397391,
               -0.055202870001177226, 0.5667186343606578, 0.7186931973380503,
               -0.015507437354325743, 0.15750322779277187, 0.21076815715176228],
    "alpha5": [0.9974408278363099, -0.007884449714907203,
               -0.059046901195591035, 1.3958712396764088, -4.516631601676276,
               -0.05585343136869692, 1.7516580039343603, -5.990208965347804,
               -0.017945336522161195, 0.5965097794825992, -2.0608879367971804],
}

_FIT_NAMES = sorted(_FITS)
_FIT_TABLE = np.array([_FITS[k] for k in _FIT_NAMES])  # (19, 11)
_FIT_TABLES: dict = {}  # (dtype, device) → _FIT_TABLE there, copied once


def _fit_table(dtype, device) -> torch.Tensor:
    """_FIT_TABLE on ``device``, copied there once: the synthesis then makes
    no host-to-device copy, so a CUDA graph can record it."""
    key = (dtype, str(device))
    if key not in _FIT_TABLES:
        _FIT_TABLES[key] = torch.as_tensor(_FIT_TABLE, dtype=dtype, device=device)
    return _FIT_TABLES[key]


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a number or a tensor) as a tensor of ``like``'s dtype on its
    device; a number is filled in there, not copied from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=like.dtype, device=like.device)
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _log(x):
    return torch.log(x) if torch.is_tensor(x) else math.log(x)


def _sqrt_clip(x):
    """sqrt(max(x, 0)) for a tensor."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def _eval_fits(eta, chi_pn):
    """All 19 coefficient fits at (eta, chiPN), each of eta's shape."""
    xi = chi_pn - 1.0
    eta2 = eta * eta
    basis = torch.stack(
        [torch.ones_like(eta), eta,
         xi, xi * eta, xi * eta2,
         xi**2, xi**2 * eta, xi**2 * eta2,
         xi**3, xi**3 * eta, xi**3 * eta2],
        dim=-1,
    )
    # The fits cancel terms of ~1e7 down to ~1e3, so a float32 sum depends
    # on its order (sigma2 and sigma4 move by ~1e-2, ~1e-4 rad of phase).
    # Sum term by term with fused multiply-adds, the order of the
    # reference's float32 dot: the product of two float32 values is exact
    # in float64, so one float64 add and one rounding emulate the FMA.
    tbl = _fit_table(basis.dtype, basis.device)
    wide = torch.float64
    vals = torch.zeros(basis.shape[:-1] + (tbl.shape[0],), dtype=basis.dtype, device=basis.device)
    for j in range(tbl.shape[1]):
        vals = (basis[..., j:j + 1].to(wide) * tbl[:, j].to(wide) + vals.to(wide)).to(basis.dtype)
    return {k: vals[..., i] for i, k in enumerate(_FIT_NAMES)}


# ---------------------------------------------------------------------------
# Final state and ringdown (Husa et al. 2016; Berti et al. QNM fits)
# ---------------------------------------------------------------------------

def final_spin(eta, chi1=0.0, chi2=0.0):
    """Dimensionless final spin, FinalSpin0815 fit."""
    seta = _sqrt_clip(1.0 - 4.0 * eta)
    m1 = 0.5 * (1.0 + seta)
    m2 = 0.5 * (1.0 - seta)
    s = m1 * m1 * chi1 + m2 * m2 * chi2
    eta2, eta3, eta4 = eta**2, eta**3, eta**4
    s2, s3 = s * s, s * s * s
    a_ns = (3.4641016151377544 * eta - 4.399247300629289 * eta2
            + 9.397292189321194 * eta3 - 13.180949901606242 * eta4)
    a_s = s * (
        (1.0 / eta - 0.0850917821418767 - 5.837029316602263 * eta)
        + (0.1014665242971878 - 2.0967746996832157 * eta) * s
        + (-1.3546806617824356 + 4.108962025369336 * eta) * s2
        + (-0.8676969352555539 + 2.064046835273906 * eta) * s3
    ) * eta
    return a_ns + a_s


def radiated_energy(eta, chi1=0.0, chi2=0.0):
    """Fraction of total mass radiated, EradRational0815 fit."""
    seta = _sqrt_clip(1.0 - 4.0 * eta)
    m1 = 0.5 * (1.0 + seta)
    m2 = 0.5 * (1.0 - seta)
    s = m1 * m1 * chi1 + m2 * m2 * chi2
    eta2, eta3, eta4 = eta**2, eta**3, eta**4
    e_ns = (0.055974469826360077 * eta + 0.5809510763115132 * eta2
            - 0.9606726679372312 * eta3 + 3.352411249771192 * eta4)
    num = 1.0 + (-0.0030302335878845507 - 2.0066110851351073 * eta
                 + 7.7050567802399215 * eta2) * s
    den = 1.0 + (-0.6714403054720589 - 1.4756929437702908 * eta
                 + 7.304676214885011 * eta2) * s
    return e_ns * num / den


def ringdown_freqs(eta, chi1=0.0, chi2=0.0):
    """(f_RD, f_damp) in units of 1/M_total: l=m=2, n=0 QNM (Berti-Cardoso-
    Will fits) rescaled by the final mass (1 − E_rad)."""
    a = final_spin(eta, chi1, chi2)
    erad = radiated_energy(eta, chi1, chi2)
    one_m_a = torch.clamp(1.0 - a, min=1e-6)
    omega_rd = 1.5251 - 1.1568 * one_m_a**0.1292
    quality = 0.7000 + 1.4187 * one_m_a ** (-0.4990)
    f_rd = omega_rd / (2.0 * PI) / (1.0 - erad)
    f_damp = f_rd / (2.0 * quality)
    return f_rd, f_damp


# ---------------------------------------------------------------------------
# TaylorF2 pieces
# ---------------------------------------------------------------------------

class _MfPowers:
    """Fractional powers of Mf from one cube root and a few square roots."""

    def __init__(self, Mf, like: torch.Tensor):
        Mf = _scalar(Mf, like)
        self.one = Mf
        self.third = torch.pow(Mf, 1.0 / 3.0)      # Mf > 0 throughout
        self.two_thirds = self.third * self.third
        self.four_thirds = Mf * self.third
        self.five_thirds = Mf * self.two_thirds
        self.two = Mf * Mf
        self.seven_thirds = self.two * self.third
        self.eight_thirds = self.two * self.two_thirds
        self.three = self.two * Mf
        self.half = torch.sqrt(Mf)
        self.quarter = torch.sqrt(self.half)
        self.three_quarters = self.half * self.quarter
        self.sixth = torch.sqrt(self.third)
        self.inv = 1.0 / Mf
        self.m_seven_sixths = self.inv / self.sixth  # Mf^{−7/6}


def _tf2_phasing(v, eta, logv, chi1=0.0, chi2=0.0):
    """Σ φ_k v^k of the 3.5PN TaylorF2 phasing."""
    eta2 = eta * eta
    eta3 = eta2 * eta
    seta = _sqrt_clip(1.0 - 4.0 * eta)
    chi_s = 0.5 * (chi1 + chi2)
    chi_a = 0.5 * (chi1 - chi2)

    phi2 = 3715.0 / 756.0 + 55.0 * eta / 9.0
    phi3 = -16.0 * PI + (113.0 / 3.0 - 76.0 * eta / 3.0) * chi_s + (113.0 / 3.0) * seta * chi_a
    phi4 = 15293365.0 / 508032.0 + 27145.0 * eta / 504.0 + 3085.0 * eta2 / 72.0
    phi5_c = PI * (38645.0 / 756.0 - 65.0 * eta / 9.0)
    phi6 = (11583231236531.0 / 4694215680.0 - 640.0 * PI**2 / 3.0 - 6848.0 * GAMMA / 21.0
            + (-15737765635.0 / 3048192.0 + 2255.0 * PI**2 / 12.0) * eta
            + 76055.0 * eta2 / 1728.0 - 127825.0 * eta3 / 1296.0)
    phi6_log = -6848.0 / 21.0
    phi7 = PI * (77096675.0 / 254016.0 + 378515.0 * eta / 1512.0 - 74045.0 * eta2 / 756.0)

    v2 = v * v
    v3 = v2 * v
    v4 = v2 * v2
    v5 = v4 * v
    v6 = v3 * v3
    v7 = v6 * v
    return (
        1.0
        + phi2 * v2
        + phi3 * v3
        + phi4 * v4
        + phi5_c * (1.0 + 3.0 * logv) * v5
        + (phi6 + phi6_log * torch.log(4.0 * v)) * v6
        + phi7 * v7
    )


def _tf2_phase(Mf, eta, chi1, chi2, P: _MfPowers):
    """Ψ_TF2(Mf) up to the free (t_c, φ_c) linear terms."""
    v = PI ** (1.0 / 3.0) * P.third
    logv = torch.log(v)
    v5 = PI ** (5.0 / 3.0) * P.five_thirds
    pre = 3.0 / (128.0 * eta * v5)
    return pre * _tf2_phasing(v, eta, logv, chi1, chi2) - PI / 4.0


def _amp_pn_series(Mf, eta, chi1, chi2, P: _MfPowers):
    """PN amplitude series Â_PN(Mf), normalised to 1 at leading order."""
    eta2 = eta * eta
    eta3 = eta2 * eta
    seta = _sqrt_clip(1.0 - 4.0 * eta)
    v = PI ** (1.0 / 3.0) * P.third
    v2 = v * v
    v3 = v2 * v
    v4 = v2 * v2
    v5 = v4 * v
    v6 = v3 * v3

    a2 = -323.0 / 224.0 + 451.0 * eta / 168.0
    a3 = (27.0 / 8.0 - 11.0 * eta / 6.0) * 0.5 * (chi1 + chi2) + (27.0 / 8.0) * seta * 0.5 * (chi1 - chi2)
    a4 = (-27312085.0 / 8128512.0 - 1975055.0 * eta / 338688.0
          + 105271.0 * eta2 / 24192.0)
    a5 = (-85.0 * PI / 64.0 + 85.0 * PI * eta / 16.0)
    a6 = (-177520268561.0 / 8583708672.0
          + (545384828789.0 / 5007163392.0 - 205.0 * PI**2 / 48.0) * eta
          - 3248849057.0 * eta2 / 178827264.0
          + 34473079.0 * eta3 / 6386688.0)
    return 1.0 + a2 * v2 + a3 * v3 + a4 * v4 + a5 * v5 + a6 * v6


# ---------------------------------------------------------------------------
# IMRPhenomD regions
# ---------------------------------------------------------------------------

_F_PHASE_INS_END = 0.018      # inspiral → intermediate phase boundary (Mf)
_F_AMP_INS_END = 0.014        # inspiral → intermediate amplitude boundary (Mf)


def _chi_pn(eta, chi1, chi2):
    seta = _sqrt_clip(1.0 - 4.0 * eta)
    chi_s = 0.5 * (chi1 + chi2)
    chi_a = 0.5 * (chi1 - chi2)
    return chi_s * (1.0 - 76.0 * eta / 113.0) + seta * chi_a


def _phase_inspiral(Mf, eta, c, chi1, chi2, P: _MfPowers):
    sig = (c["sigma1"] * P.one
           + 0.75 * c["sigma2"] * P.four_thirds
           + 0.6 * c["sigma3"] * P.five_thirds
           + 0.5 * c["sigma4"] * P.two)
    return _tf2_phase(Mf, eta, chi1, chi2, P) + sig / eta


def _dtf2_phase(Mf, eta, chi1=0.0, chi2=0.0):
    """Analytic dΨ_TF2/d(Mf) (finite differences cancel in float32)."""
    eta2 = eta * eta
    eta3 = eta2 * eta
    seta = _sqrt_clip(1.0 - 4.0 * eta)
    chi_s = 0.5 * (chi1 + chi2)
    chi_a = 0.5 * (chi1 - chi2)
    phi2 = 3715.0 / 756.0 + 55.0 * eta / 9.0
    phi3 = -16.0 * PI + (113.0 / 3.0 - 76.0 * eta / 3.0) * chi_s + (113.0 / 3.0) * seta * chi_a
    phi4 = 15293365.0 / 508032.0 + 27145.0 * eta / 504.0 + 3085.0 * eta2 / 72.0
    phi5_c = PI * (38645.0 / 756.0 - 65.0 * eta / 9.0)
    phi6 = (11583231236531.0 / 4694215680.0 - 640.0 * PI**2 / 3.0 - 6848.0 * GAMMA / 21.0
            + (-15737765635.0 / 3048192.0 + 2255.0 * PI**2 / 12.0) * eta
            + 76055.0 * eta2 / 1728.0 - 127825.0 * eta3 / 1296.0)
    phi6_log = -6848.0 / 21.0
    phi7 = PI * (77096675.0 / 254016.0 + 378515.0 * eta / 1512.0 - 74045.0 * eta2 / 756.0)

    v = (PI * Mf) ** (1.0 / 3.0)
    # Ψ = 3/(128η) [v^-5 + φ2 v^-3 + φ3 v^-2 + φ4 v^-1 + φ5c(1+3 log v)
    #              + (φ6 + φ6l log 4v) v + φ7 v²],  dv/dMf = v/(3 Mf)
    dsum_dv = (
        -5.0 * v ** (-6.0)
        - 3.0 * phi2 * v ** (-4.0)
        - 2.0 * phi3 * v ** (-3.0)
        - phi4 * v ** (-2.0)
        + 3.0 * phi5_c / v
        + (phi6 + phi6_log * (_log(4.0 * v) + 1.0))
        + 2.0 * phi7 * v
    )
    return 3.0 / (128.0 * eta) * dsum_dv * v / (3.0 * Mf)


def _dphase_inspiral(Mf, eta, c, chi1, chi2):
    dsig = (c["sigma1"] + c["sigma2"] * Mf ** (1.0 / 3.0)
            + c["sigma3"] * Mf ** (2.0 / 3.0) + c["sigma4"] * Mf)
    return _dtf2_phase(Mf, eta, chi1, chi2) + dsig / eta


def _phase_intermediate(Mf, eta, c, P: _MfPowers):
    inv3 = P.inv * P.inv * P.inv
    return (c["beta1"] * P.one + c["beta2"] * torch.log(P.one)
            - c["beta3"] / 3.0 * inv3) / eta


def _dphase_intermediate(Mf, eta, c):
    return (c["beta1"] + c["beta2"] / Mf + c["beta3"] * Mf ** (-4.0)) / eta


def _phase_mr(Mf, eta, c, f_rd, f_damp, P: _MfPowers):
    return (c["alpha1"] * P.one
            - c["alpha2"] * P.inv
            + 4.0 / 3.0 * c["alpha3"] * P.three_quarters
            + c["alpha4"] * torch.atan((P.one - c["alpha5"] * f_rd) / f_damp)) / eta


def _dphase_mr(Mf, eta, c, f_rd, f_damp):
    return (c["alpha1"]
            + c["alpha2"] / Mf**2
            + c["alpha3"] * Mf ** (-0.25)
            + c["alpha4"] * f_damp / (f_damp**2 + (Mf - c["alpha5"] * f_rd) ** 2)) / eta


def _amp_inspiral(Mf, eta, c, chi1, chi2, P: _MfPowers):
    return (_amp_pn_series(Mf, eta, chi1, chi2, P)
            + c["rho1"] * P.seven_thirds
            + c["rho2"] * P.eight_thirds
            + c["rho3"] * P.three)


def _damp_pn_series(Mf, eta, chi1=0.0, chi2=0.0):
    """Analytic d/d(Mf) of the PN amplitude series."""
    eta2 = eta * eta
    eta3 = eta2 * eta
    seta = _sqrt_clip(1.0 - 4.0 * eta)
    v = (PI * Mf) ** (1.0 / 3.0)
    a2 = -323.0 / 224.0 + 451.0 * eta / 168.0
    a3 = (27.0 / 8.0 - 11.0 * eta / 6.0) * 0.5 * (chi1 + chi2) + (27.0 / 8.0) * seta * 0.5 * (chi1 - chi2)
    a4 = (-27312085.0 / 8128512.0 - 1975055.0 * eta / 338688.0
          + 105271.0 * eta2 / 24192.0)
    a5 = (-85.0 * PI / 64.0 + 85.0 * PI * eta / 16.0)
    a6 = (-177520268561.0 / 8583708672.0
          + (545384828789.0 / 5007163392.0 - 205.0 * PI**2 / 48.0) * eta
          - 3248849057.0 * eta2 / 178827264.0
          + 34473079.0 * eta3 / 6386688.0)
    # d(v^k)/dMf = (k/3) v^k / Mf
    return (2.0 * a2 * v**2 + 3.0 * a3 * v**3 + 4.0 * a4 * v**4
            + 5.0 * a5 * v**5 + 6.0 * a6 * v**6) / (3.0 * Mf)


def _damp_inspiral(Mf, eta, c, chi1, chi2):
    return (_damp_pn_series(Mf, eta, chi1, chi2)
            + 7.0 / 3.0 * c["rho1"] * Mf ** (4.0 / 3.0)
            + 8.0 / 3.0 * c["rho2"] * Mf ** (5.0 / 3.0)
            + 3.0 * c["rho3"] * Mf**2)


def _amp_mr(Mf, c, f_rd, f_damp):
    g3fd = c["gamma3"] * f_damp
    dfr = Mf - f_rd
    return (c["gamma1"] * g3fd / (dfr**2 + g3fd**2)
            * torch.exp(-c["gamma2"] * dfr / g3fd))


def _damp_mr(Mf, c, f_rd, f_damp):
    g3fd = c["gamma3"] * f_damp
    dfr = Mf - f_rd
    a = _amp_mr(Mf, c, f_rd, f_damp)
    return a * (-c["gamma2"] / g3fd - 2.0 * dfr / (dfr**2 + g3fd**2))


def _amp_peak_freq(c, f_rd, f_damp):
    """Frequency of the amplitude peak (end of the intermediate region)."""
    g2 = c["gamma2"]
    g3fd = c["gamma3"] * f_damp
    # for gamma2 >= 1 the analytic extremum is complex; LAL clamps as below
    safe = _sqrt_clip(1.0 - g2**2)
    shift = torch.where(g2 <= 1.0, g3fd * (safe - 1.0) / g2, -g3fd / g2)
    return torch.abs(f_rd + shift)


def _intermediate_amp_poly(f1, f2, f3, v1, v2, v3, d1, d3):
    """Quartic through (f1, v1, d1), (f2, v2), (f3, v3, d3), solved in the
    normalised coordinate u = (f − f1)/(f3 − f1) ∈ [0, 1] so the 5×5
    collocation system stays well conditioned in float32. All arguments
    broadcast to one per-template shape S; returns (coefficients (S..., 5),
    span)."""
    span = f3 - f1
    u2 = (f2 - f1) / span
    d1u = d1 * span
    d3u = d3 * span
    shape = torch.broadcast_shapes(*(t.shape for t in (span, v1, v2, v3, d1u, d3u)))
    one = torch.ones(shape, dtype=span.dtype, device=span.device)
    zero = torch.zeros_like(one)

    def row_v(u):
        return torch.stack([one, u, u**2, u**3, u**4], dim=-1)

    def row_d(u):
        return torch.stack([zero, one, 2 * u, 3 * u**2, 4 * u**3], dim=-1)

    A = torch.stack(
        [row_v(zero), row_d(zero), row_v(u2 * one), row_v(one), row_d(one)],
        dim=-2,
    )
    b = torch.stack([v1 * one, d1u * one, v2 * one, v3 * one, d3u * one], dim=-1)
    # solve_ex: solve without its check of the factorisation on the host,
    # which a CUDA graph cannot record (A is never singular here)
    coeff = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
    return coeff, span


def imrphenomd_ampphase(freqs, m1, m2, chi1=0.0, chi2=0.0,
                        dist_mpc=constants.DEFAULT_DISTANCE_MPC,
                        f_low=constants.DEFAULT_F_LOW, f_high=None):
    """IMRPhenomD strain as a real (amplitude, phase) pair, h̃ = amp·e^{−i·phase},
    with ``amp`` zeroed outside [f_low, f_high].

    ``freqs`` is a (K,) tensor (its dtype sets the precision, float32 at
    least); ``m1``/``m2`` are scalars or (B,) tensors of solar masses. The
    result is (K,) for scalar masses and (B, K) for batched ones. ``f_high``
    defaults to Mf = 0.3, the PhenomD validity ceiling
    (ref call surface: gw_template_maker.py:507-516).
    """
    dtype = freqs.dtype if freqs.dtype == torch.float64 else torch.float32
    freqs = freqs.to(dtype)
    m1 = torch.as_tensor(m1, dtype=dtype, device=freqs.device)
    m2 = torch.as_tensor(m2, dtype=dtype, device=freqs.device)
    scalar = m1.ndim == 0 and m2.ndim == 0
    m1 = m1.reshape(-1, 1)
    m2 = m2.reshape(-1, 1)

    m_total = m1 + m2
    m_sec = m_total * constants.MTSUN_SI
    eta = (m1 * m2) / m_total**2

    chi_pn = _chi_pn(eta, chi1, chi2)
    c = _eval_fits(eta, chi_pn * torch.ones_like(eta))
    f_rd, f_damp = ringdown_freqs(eta, chi1, chi2)

    Mf = torch.clamp(freqs * m_sec, min=1e-9)
    Pw = _MfPowers(Mf, Mf)

    # ---- phase: three regions stitched C(1) ---------------------------
    f1 = _F_PHASE_INS_END
    f2 = 0.5 * f_rd
    P1 = _MfPowers(f1, eta)

    # intermediate constants from continuity at f1
    c2_int = _dphase_inspiral(f1, eta, c, chi1, chi2) - _dphase_intermediate(f1, eta, c)
    c1_int = (_phase_inspiral(f1, eta, c, chi1, chi2, P1)
              - _phase_intermediate(f1, eta, c, P1) - c2_int * f1)

    P2 = _MfPowers(f2, eta)
    phi_int_f2 = _phase_intermediate(f2, eta, c, P2) + c1_int + c2_int * f2
    dphi_int_f2 = _dphase_intermediate(f2, eta, c) + c2_int

    # merger-ringdown constants from continuity at f2
    c2_mrd = dphi_int_f2 - _dphase_mr(f2, eta, c, f_rd, f_damp)
    c1_mrd = phi_int_f2 - _phase_mr(f2, eta, c, f_rd, f_damp, P2) - c2_mrd * f2

    phase = torch.where(
        Mf < f1,
        _phase_inspiral(Mf, eta, c, chi1, chi2, Pw),
        torch.where(
            Mf < f2,
            _phase_intermediate(Mf, eta, c, Pw) + c1_int + c2_int * Mf,
            _phase_mr(Mf, eta, c, f_rd, f_damp, Pw) + c1_mrd + c2_mrd * Mf,
        ),
    )

    # time shift so the group delay at the amplitude peak is zero (the
    # merger sits at t ≈ 0 of the inverse transform, LAL's epoch convention)
    f_peak = _amp_peak_freq(c, f_rd, f_damp)
    t0 = _dphase_mr(f_peak, eta, c, f_rd, f_damp) + c2_mrd
    phase = phase - t0 * (Mf - f1)

    # ---- amplitude: three regions -------------------------------------
    fa1 = _F_AMP_INS_END
    fa3 = f_peak
    fa2 = 0.5 * (fa1 + fa3)

    Pa1 = _MfPowers(fa1, eta)
    v1 = _amp_inspiral(fa1, eta, c, chi1, chi2, Pa1)
    d1 = _damp_inspiral(fa1, eta, c, chi1, chi2)
    v2 = c["v2"]
    v3 = _amp_mr(fa3, c, f_rd, f_damp)
    d3 = _damp_mr(fa3, c, f_rd, f_damp)
    delta, span = _intermediate_amp_poly(
        _scalar(fa1, eta), fa2, fa3,
        v1, v2, v3, d1, d3,
    )

    u = torch.clamp((Mf - fa1) / span, 0.0, 1.0)
    amp_int = (delta[..., 0] + delta[..., 1] * u + delta[..., 2] * u**2
               + delta[..., 3] * u**3 + delta[..., 4] * u**4)

    rel_amp = torch.where(
        Mf < fa1,
        _amp_inspiral(Mf, eta, c, chi1, chi2, Pw),
        torch.where(Mf < fa3, amp_int, _amp_mr(Mf, c, f_rd, f_damp)),
    )

    amp0 = (constants.STRAIN_SCALE
            * math.sqrt(5.0 / 24.0) / PI ** (2.0 / 3.0) * torch.sqrt(eta)
            * m_sec**2 / (dist_mpc * constants.MPC_SI / constants.C_SI))
    amp = amp0 * Pw.m_seven_sixths * rel_amp

    # ---- band limit ------------------------------------------------------
    if f_high is None:
        f_high = 0.3 / m_sec  # Mf = 0.3, the PhenomD validity ceiling
    band = (freqs >= f_low) & (freqs <= f_high)
    amp = torch.where(band, amp, torch.zeros_like(amp))
    if scalar:
        return amp[0], phase[0]
    return amp, phase


def _polarisations(h, inclination):
    """(h̃+, h̃×) of a complex h̃ seen at ``inclination``."""
    cosi = math.cos(inclination)
    return 0.5 * (1.0 + cosi**2) * h, cosi * h * complex(math.cos(PI / 2.0), -math.sin(PI / 2.0))


def _complex_strain(amp, phase):
    """amp·e^{−i·phase} in the complex dtype of ``amp``'s precision."""
    return torch.polar(amp, -phase)


def taylorf2_htilde(freqs, m1, m2, dist_mpc=constants.DEFAULT_DISTANCE_MPC,
                    inclination=0.0, phi_ref=0.0, f_low=constants.DEFAULT_F_LOW, f_high=None):
    """3.5PN TaylorF2 (h̃+, h̃×) on the frequency grid ``freqs`` [Hz]: the
    inspiral-only SPA model, zeroed outside [f_low, f_high] (``f_high``
    defaults to the ISCO). Masses and the result's shape as in
    :func:`imrphenomd_ampphase`; complex64 (complex128 for float64
    ``freqs``)."""
    dtype = freqs.dtype if freqs.dtype == torch.float64 else torch.float32
    freqs = freqs.to(dtype)
    m1 = torch.as_tensor(m1, dtype=dtype, device=freqs.device)
    m2 = torch.as_tensor(m2, dtype=dtype, device=freqs.device)
    scalar = m1.ndim == 0 and m2.ndim == 0
    m1, m2 = m1.reshape(-1, 1), m2.reshape(-1, 1)
    m_sec = (m1 + m2) * constants.MTSUN_SI
    eta = (m1 * m2) / (m1 + m2) ** 2
    Mf = torch.clamp(freqs * m_sec, min=1e-9)
    P = _MfPowers(Mf, Mf)

    psi = _tf2_phase(Mf, eta, 0.0, 0.0, P) + 2.0 * phi_ref
    amp0 = (constants.STRAIN_SCALE
            * math.sqrt(5.0 / 24.0) / PI ** (2.0 / 3.0) * torch.sqrt(eta)
            * m_sec**2 / (dist_mpc * constants.MPC_SI / constants.C_SI))
    amp = amp0 * P.m_seven_sixths * _amp_pn_series(Mf, eta, 0.0, 0.0, P)
    if f_high is None:
        f_high = 1.0 / (6.0**1.5 * PI * m_sec)  # the ISCO: the inspiral model's end
    band = (freqs >= f_low) & (freqs <= f_high)
    h = torch.where(band, _complex_strain(amp, psi), torch.zeros((), dtype=amp.dtype,
                                                                 device=amp.device))
    hp, hc = _polarisations(h, inclination)
    return (hp[0], hc[0]) if scalar else (hp, hc)


def imrphenomd_htilde(freqs, m1, m2, chi1=0.0, chi2=0.0,
                      dist_mpc=constants.DEFAULT_DISTANCE_MPC, inclination=0.0, phi_ref=0.0,
                      f_low=constants.DEFAULT_F_LOW, f_high=None):
    """IMRPhenomD (h̃+, h̃×) as complex tensors: :func:`imrphenomd_ampphase`
    as h̃ = amp·e^{−i(phase + 2φ_ref)} seen at ``inclination``. For
    validation and interop; the bank's pipeline uses the (amp, phase)
    form."""
    amp, phase = imrphenomd_ampphase(freqs, m1, m2, chi1, chi2, dist_mpc=dist_mpc, f_low=f_low,
                                     f_high=f_high)
    return _polarisations(_complex_strain(amp, phase + 2.0 * phi_ref), inclination)
