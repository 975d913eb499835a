"""Bundled atomic-line database (replaces the reference's linetools dependency).

A copy of :mod:`mcalf_tpu.atomic.data` with its own line registry, so
:func:`register_line` here changes the port's table only;
tests/test_torch_host_copies.py holds the two tables equal.

The reference looks transitions up by name in ``linetools.lists.linelist
.LineList('ISM')`` (the reference's mcalf/routines/hires_fitter.py:90-113) and
then overrides three CrII entries with values from R. Cooke's ALIS atomic
database.  This module bundles the same information as plain data: for each
named transition we store

* ``wrest``  -- rest wavelength [Angstrom]
* ``f``      -- oscillator strength (dimensionless)
* ``gamma``  -- damping constant [s^-1]

The CIV doublet values are exact linetools/Morton-2003 values, verified
against the reference's own mock spectra to machine precision (see
BASELINE.md).  The CrII entries carry the reference's ALIS overrides
(hires_fitter.py:102-110) out of the box.  Other entries are Morton (2003)
values as distributed with common fitting codes; for precision work on those
species users can override any line via :func:`register_line` or the
``atomfile`` config option (an extension over the reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List


@dataclass(frozen=True)
class LineData:
    """Atomic data for one transition (cf. linetools dict fields
    ``wrest``/``f``/``gamma`` used at hires_fitter.py:534-541)."""

    name: str
    wrest: float  # Angstrom
    f: float      # oscillator strength
    gamma: float  # s^-1

    def replace(self, **kw) -> "LineData":
        d = dict(name=self.name, wrest=self.wrest, f=self.f, gamma=self.gamma)
        d.update(kw)
        return LineData(**d)


def _L(name, wrest, f, gamma):
    return (name, LineData(name, float(wrest), float(f), float(gamma)))


# name -> LineData.  Names use the linetools "ION wrest" convention so that
# configs written for the reference work unchanged.
_LINES: Dict[str, LineData] = dict(
    [
        # --- Hydrogen Lyman series (Morton 2003) ---
        _L("HI 1215", 1215.6700, 0.416400, 6.265e8),
        _L("HI 1025", 1025.7222, 0.079120, 1.897e8),
        _L("HI 972", 972.5368, 0.029000, 8.127e7),
        _L("HI 949", 949.7431, 0.013940, 4.204e7),
        _L("HI 937", 937.8035, 0.007804, 2.450e7),
        _L("HI 930", 930.7483, 0.004817, 1.236e7),
        _L("HI 926", 926.2257, 0.003183, 8.255e6),
        # --- CIV doublet (exact linetools values; BASELINE.md parity) ---
        _L("CIV 1548", 1548.2040, 0.189900, 2.6430e8),
        _L("CIV 1550", 1550.7810, 0.094750, 2.6280e8),
        # --- Carbon ---
        _L("CII 1334", 1334.5323, 0.127800, 2.880e8),
        _L("CII 1036", 1036.3367, 0.118000, 7.380e8),
        _L("CIII 977", 977.0201, 0.757000, 1.767e9),
        # --- Magnesium ---
        _L("MgII 2796", 2796.3520, 0.612300, 2.612e8),
        _L("MgII 2803", 2803.5310, 0.305400, 2.592e8),
        _L("MgI 2852", 2852.9642, 1.810000, 4.950e8),
        # --- Silicon ---
        _L("SiII 1190", 1190.4158, 0.292000, 6.530e8),
        _L("SiII 1193", 1193.2897, 0.582000, 2.690e9),
        _L("SiII 1260", 1260.4221, 1.180000, 2.950e9),
        _L("SiII 1304", 1304.3702, 0.086300, 1.010e9),
        _L("SiII 1526", 1526.7066, 0.127000, 1.130e9),
        _L("SiII 1808", 1808.0129, 0.002080, 2.540e8),
        _L("SiIII 1206", 1206.5000, 1.630000, 2.550e9),
        _L("SiIV 1393", 1393.7550, 0.528000, 8.800e8),
        _L("SiIV 1402", 1402.7700, 0.262000, 8.630e8),
        # --- Oxygen / Nitrogen ---
        _L("OI 1302", 1302.1685, 0.048000, 5.650e8),
        _L("OVI 1031", 1031.9261, 0.132500, 4.149e8),
        _L("OVI 1037", 1037.6167, 0.065800, 4.076e8),
        _L("NV 1238", 1238.8210, 0.156000, 3.400e8),
        _L("NV 1242", 1242.8040, 0.077700, 3.370e8),
        _L("NI 1200", 1200.2233, 0.088490, 4.070e8),
        # --- Iron ---
        _L("FeII 1608", 1608.4511, 0.057700, 2.740e8),
        _L("FeII 2344", 2344.2140, 0.114200, 2.680e8),
        _L("FeII 2374", 2374.4612, 0.031300, 3.090e8),
        _L("FeII 2382", 2382.7650, 0.320000, 3.100e8),
        _L("FeII 2586", 2586.6500, 0.069180, 2.720e8),
        _L("FeII 2600", 2600.1729, 0.238700, 2.700e8),
        # --- Aluminium ---
        _L("AlII 1670", 1670.7886, 1.740000, 1.390e9),
        _L("AlIII 1854", 1854.7164, 0.559000, 5.420e8),
        _L("AlIII 1862", 1862.7895, 0.278000, 5.360e8),
        # --- Chromium: wrest Morton 2003; f/gamma carry the reference's
        # ALIS overrides (hires_fitter.py:102-110) as the *default*. ---
        _L("CrII 2056", 2056.2569, 0.103000, 4.07e8),
        _L("CrII 2062", 2062.2361, 0.075900, 4.06e8),
        _L("CrII 2066", 2066.1640, 0.051200, 4.17e8),
        # --- Zinc (often blended with CrII) ---
        _L("ZnII 2026", 2026.1370, 0.501000, 4.070e8),
        _L("ZnII 2062", 2062.6604, 0.246000, 3.860e8),
        # --- Hydrogen Lyman series continuation (Morton 2003 f-values;
        # gamma extrapolated along the measured A ~ n^-3 series, accurate
        # to a few % -- negligible for these weak high-order lines) ---
        _L("HI 923", 923.1504, 0.002216, 5.79e6),
        _L("HI 920", 920.9631, 0.001605, 4.21e6),
        _L("HI 919", 919.3514, 0.001201, 3.16e6),
        _L("HI 918", 918.1294, 0.000921, 2.43e6),
        _L("HI 917", 917.1806, 0.000723, 1.91e6),
        # --- Deuterium Ly-alpha/beta (isotope-shifted HI; same f/gamma) ---
        _L("DI 1215", 1215.3394, 0.416400, 6.265e8),
        _L("DI 1025", 1025.4433, 0.079120, 1.897e8),
        # --- Excited fine-structure carbon (shares the CII 1334 upper
        # term, hence its damping constant) ---
        _L("CII* 1335", 1335.7077, 0.114900, 2.880e8),
        # --- Nitrogen multiplet companions of NI 1200.22 ---
        _L("NI 1199", 1199.5496, 0.130000, 4.070e8),
        _L("NI 1200.2", 1200.2233, 0.088490, 4.070e8),  # alias of NI 1200
        _L("NI 1200.7", 1200.7098, 0.044230, 4.070e8),
        # --- Sulphur (Morton 2003 f; gamma = two-level A_ul from f, exact
        # when the upper level decays only through this channel -- true for
        # these resonance triplet members to ~10%) ---
        _L("SII 1250", 1250.5840, 0.005453, 4.65e7),
        _L("SII 1253", 1253.8110, 0.010880, 4.62e7),
        _L("SII 1259", 1259.5190, 0.016240, 4.55e7),
        # --- Manganese resonance triplet ---
        _L("MnII 2576", 2576.8770, 0.350800, 2.74e8),
        _L("MnII 2594", 2594.4990, 0.271000, 2.69e8),
        _L("MnII 2606", 2606.4620, 0.192700, 2.64e8),
        # --- Nickel (strongest UV lines; gamma via the same two-level
        # A_ul estimate) ---
        _L("NiII 1709", 1709.6042, 0.032400, 7.39e7),
        _L("NiII 1741", 1741.5531, 0.042700, 9.39e7),
        _L("NiII 1751", 1751.9157, 0.027700, 6.01e7),
        # --- Titanium (ground-state line redward of the Lyman forest) ---
        _L("TiII 3384", 3384.7301, 0.358000, 1.39e8),
        # --- Magnesium neutral line blended with ZnII 2026 ---
        _L("MgI 2026", 2026.4768, 0.112000, 6.06e7),
        # --- Calcium H & K (vacuum wavelengths) ---
        _L("CaII 3934", 3934.7770, 0.626700, 1.456e8),
        _L("CaII 3969", 3969.5910, 0.311600, 1.414e8),
        # --- Sodium D doublet (vacuum wavelengths) ---
        _L("NaI 5891", 5891.5833, 0.640800, 6.16e7),
        _L("NaI 5897", 5897.5581, 0.319900, 6.14e7),
        # =================================================================
        # Breadth extension toward linetools' ISM namespace (reference
        # hires_fitter.py:90-113 resolves ANY named ISM transition).
        # Oscillator strengths are Morton (2003) values as distributed
        # with common fitting codes.  Damping constants marked "est" are
        # two-level estimates A = 6.670e15 * f * (g_l/g_u) / wrest^2 (the
        # same construction used for the SII/NiII entries above, exact
        # for CIV/Li-like ions) or the dominant-channel width of the
        # shared upper level for weak satellite lines; damping wings are
        # invisible for these weak metal lines at ISM columns, and any
        # entry can be overridden via register_line()/atomfile.
        # =================================================================
        # --- Lyman series to near the limit (f: Wiese et al.; gamma
        # extrapolated along A ~ n^-3 as above) ---
        _L("HI 916", 916.4290, 0.000577, 1.53e6),
        _L("HI 915", 915.8240, 0.000469, 1.24e6),
        _L("HI 915.3", 915.3290, 0.000386, 1.02e6),
        _L("HI 914.9", 914.9190, 0.000321, 8.5e5),
        _L("HI 914.5", 914.5760, 0.000270, 7.2e5),
        _L("HI 914.2", 914.2860, 0.000230, 6.1e5),
        _L("HI 914.0", 914.0390, 0.000197, 5.2e5),
        # --- Deuterium series continuation (isotope-shifted HI) ---
        _L("DI 972", 972.2722, 0.029000, 8.127e7),
        _L("DI 949", 949.4847, 0.013940, 4.204e7),
        _L("DI 937", 937.5484, 0.007804, 2.450e7),
        # --- Neutral carbon ground-level multiplets ---
        _L("CI 1656", 1656.9283, 0.149000, 3.60e8),
        _L("CI 1560", 1560.3092, 0.077400, 1.27e8),
        _L("CI 1328", 1328.8333, 0.075800, 2.88e8),
        _L("CI 1280", 1280.1353, 0.026300, 1.06e8),
        _L("CI 1277", 1277.2452, 0.085300, 2.30e8),
        _L("CI 945", 945.1910, 0.273000, 1.30e9),   # est
        # --- CI fine-structure excited levels (3P1 = CI*, 3P2 = CI**);
        # upper-level widths shared with the ground multiplet ---
        _L("CI* 1656.2", 1656.2672, 0.058900, 3.60e8),
        _L("CI* 1657.3", 1657.3792, 0.035600, 3.60e8),
        _L("CI* 1657.9", 1657.9068, 0.047300, 3.60e8),
        _L("CI** 1657", 1657.0082, 0.104000, 3.60e8),
        _L("CI** 1658", 1658.1212, 0.035600, 3.60e8),
        # --- CII far-UV resonance + excited fine structure ---
        _L("CII 903.9", 903.9616, 0.333000, 2.72e9),  # est
        _L("CII 903.6", 903.6235, 0.166000, 1.36e9),  # est
        _L("CII* 1037", 1037.0182, 0.123000, 7.6e8),  # est
        # --- NI 1134 resonance triplet ---
        _L("NI 1134.1", 1134.1653, 0.014600, 7.6e7),  # est
        _L("NI 1134.4", 1134.4149, 0.028700, 1.49e8),  # est
        _L("NI 1134.9", 1134.9803, 0.041600, 2.15e8),  # est
        # --- Ionized nitrogen ---
        _L("NII 1083", 1083.9937, 0.111000, 6.30e8),  # est
        _L("NII 915", 915.6131, 0.159000, 1.27e9),    # est
        _L("NIII 989", 989.7990, 0.123000, 8.4e8),    # est
        # --- OI far-UV series + fine-structure companions of 1302 ---
        _L("OI 1039", 1039.2304, 0.009200, 9.4e7),    # est
        _L("OI 988", 988.7734, 0.046500, 3.17e8),     # est
        _L("OI 976", 976.4481, 0.003310, 2.31e7),     # est
        _L("OI 950", 950.8846, 0.001580, 1.17e7),     # est
        _L("OI 936", 936.6295, 0.003650, 2.78e7),     # est
        _L("OI* 1304", 1304.8576, 0.047800, 5.6e8),
        _L("OI** 1306", 1306.0286, 0.047800, 5.6e8),
        # --- Phosphorus ---
        _L("PII 1152", 1152.8180, 0.245000, 1.23e9),  # est
        _L("PII 1301", 1301.8743, 0.019600, 7.7e7),   # est
        _L("PV 1117", 1117.9774, 0.450000, 1.20e9),   # Li-like, exact g
        _L("PV 1128", 1128.0078, 0.221000, 1.16e9),   # Li-like, exact g
        # --- Argon ---
        _L("ArI 1048", 1048.2199, 0.263000, 5.3e8),   # g_l/g_u = 1/3
        _L("ArI 1066", 1066.6599, 0.067500, 1.32e8),  # g_l/g_u = 1/3
        # --- Sulphur ions ---
        _L("SIII 1190", 1190.2030, 0.022200, 1.05e8),  # est
        _L("SIII 1012", 1012.4950, 0.035500, 2.31e8),  # est
        _L("SIV 1062", 1062.6620, 0.049400, 1.5e8),    # est
        _L("SVI 933", 933.3780, 0.437000, 1.67e9),     # Li-like, exact g
        _L("SVI 944", 944.5230, 0.215000, 1.61e9),     # Li-like, exact g
        # --- SiII far-UV + excited fine structure (SiII*) ---
        _L("SiII 989", 989.8731, 0.171000, 5.8e8),     # est
        _L("SiII 1020", 1020.6989, 0.016800, 5.4e7),   # est
        _L("SiII* 1264", 1264.7377, 1.050000, 2.92e9),
        _L("SiII* 1194", 1194.5002, 0.737000, 3.45e9),
        _L("SiII* 1197", 1197.3938, 0.150000, 1.40e9),
        _L("SiII* 1309", 1309.2757, 0.080000, 6.2e8),  # est
        _L("SiII* 1533", 1533.4312, 0.129000, 7.3e8),  # est
        _L("SiII* 1816", 1816.9285, 0.001660, 6.7e6),  # est
        # --- FeII far-UV / weak optical-UV multiplets (weak-line gammas
        # are the dominant-channel upper-level widths) ---
        _L("FeII 1063", 1063.1764, 0.054700, 3.2e8),   # est
        _L("FeII 1081", 1081.8748, 0.012600, 3.0e8),   # est
        _L("FeII 1096", 1096.8769, 0.032700, 3.0e8),   # est
        _L("FeII 1121", 1121.9748, 0.029000, 3.0e8),   # est
        _L("FeII 1125", 1125.4477, 0.015600, 3.0e8),   # est
        _L("FeII 1143", 1143.2260, 0.019200, 3.0e8),   # est
        _L("FeII 1144", 1144.9379, 0.083000, 4.2e8),   # est
        _L("FeII 1260", 1260.5330, 0.024000, 2.9e8),   # est
        _L("FeII 1611", 1611.2003, 0.001380, 2.9e8),   # est
        _L("FeII 2249", 2249.8768, 0.001820, 3.3e8),   # est
        _L("FeII 2260", 2260.7805, 0.002440, 3.2e8),   # est
        _L("FeIII 1122", 1122.5260, 0.054400, 2.9e8),  # est
        # --- More nickel ---
        _L("NiII 1317", 1317.2170, 0.057100, 2.2e8),   # est
        _L("NiII 1370", 1370.1320, 0.076900, 2.7e8),   # est
        _L("NiII 1454", 1454.8420, 0.032300, 1.0e8),   # est
        # --- MnII far-UV resonance triplet ---
        _L("MnII 1197", 1197.1840, 0.217000, 1.0e9),   # est
        _L("MnII 1199", 1199.3910, 0.169000, 7.8e8),   # est
        _L("MnII 1201", 1201.1180, 0.121000, 5.6e8),   # est
        # --- Weak MgII doublet (3s-4p) ---
        _L("MgII 1239", 1239.9253, 0.000632, 1.4e8),   # est
        _L("MgII 1240", 1240.3947, 0.000356, 1.4e8),   # est
        # --- More titanium ---
        _L("TiII 1910", 1910.6123, 0.104000, 1.9e8),   # est
        _L("TiII 3073", 3073.8633, 0.121000, 8.5e7),   # est
        _L("TiII 3230", 3230.1310, 0.068700, 4.4e7),   # est
        _L("TiII 3242", 3242.9180, 0.232000, 1.47e8),  # est
        # --- Odd-Z iron-peak / heavy tracers ---
        _L("CoII 2012", 2012.1664, 0.036800, 6.1e7),   # est
        _L("CuII 1358", 1358.7730, 0.263000, 9.5e8),   # est
        _L("GeII 1237", 1237.0591, 0.875600, 1.9e9),   # est
    ]
)


class LineNotFoundError(KeyError):
    """Raised when a transition name is not in the database (the reference
    prints an error and returns; we raise, hires_fitter.py:97-99)."""


def get_line(name: str) -> LineData:
    """Look one transition up by its linetools-style name, e.g. 'CIV 1548'."""
    key = " ".join(str(name).split())
    try:
        return _LINES[key]
    except KeyError:
        raise LineNotFoundError(
            f"Line {name!r} not found in the bundled atomic database. "
            f"Known lines: {sorted(_LINES)}. Use register_line()/atomfile "
            f"to add custom transitions."
        ) from None


def get_lines(names: Iterable[str]) -> List[LineData]:
    return [get_line(n) for n in names]


def register_line(name: str, wrest: float, f: float, gamma: float) -> LineData:
    """Add or override a transition at runtime (also used by the ``atomfile``
    config extension)."""
    key = " ".join(str(name).split())
    line = LineData(key, float(wrest), float(f), float(gamma))
    _LINES[key] = line
    return line


def load_atomfile(path: str) -> int:
    """Load extra transitions from a whitespace-separated text file with
    columns: ion wave_label wrest f gamma  (e.g. ``CIV 1548 1548.204 0.1899
    2.643e8``).  Lines starting with '#' are comments.  Returns the number of
    transitions registered."""
    count = 0
    with open(path) as fh:
        for raw in fh:
            s = raw.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split()
            if len(parts) != 5:
                raise ValueError(f"atomfile line not understood: {raw!r}")
            ion, label, wrest, f, gamma = parts
            register_line(f"{ion} {label}", float(wrest), float(f), float(gamma))
            count += 1
    return count


def available_lines() -> List[str]:
    return sorted(_LINES)
