"""The paper's contribution: shifted compression operators + DCGD-SHIFT.

Codecs (``compressors``), the shift-rule engine (``shift_rules``),
Algorithm 1 and its step sizes (``algorithms``), the compressed-iterate
methods (``iterate_comp``); ``core.simulate`` runs them on convex problems.

The names below are those the reference's ``repro.core`` exports, loaded
on first use: ``comm`` and ``dist`` import ``core.compressors``, and the
rules import ``comm``, so importing them all here would be circular.
"""

import importlib

_EXPORTS = {
    "compressors": (
        "BernoulliP", "Compressor", "Contractive", "Identity", "Induced",
        "Int8Stochastic", "NaturalCompression", "NaturalDithering",
        "PackedBits", "RandK", "ScaledSign", "TernGrad", "TopK", "Unbiased",
        "Zero", "aot_wire_bits", "make_compressor", "shifted", "tree_bits",
        "tree_compress", "tree_shifted_compress", "tree_size", "wire_bits"),
    "shift_rules": (
        "SHIFT_RULES", "DianaShift", "EF21Shift", "EFBVShift", "FixedShift",
        "RandDianaShift", "ShiftRule", "StarShift", "dense_message_bits",
        "make_shift_rule", "residual_sq_diag"),
    "algorithms": (
        "DCGDShift", "DCGDState", "efbv_params", "rand_diana_default_p",
        "stepsize_dcgd_fixed", "stepsize_dcgd_star", "stepsize_diana",
        "stepsize_ef21", "stepsize_efbv", "stepsize_rand_diana"),
    "iterate_comp": ("GDCI", "VRGDCI", "stepsize_gdci", "stepsize_vr_gdci"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"),
                   name)
