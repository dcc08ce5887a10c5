"""C++ iostream-compatible number formatting.

The golden outputs are produced by `std::cout <<` with default settings:
6 significant digits, %g-style trailing-zero trimming, "inf"/"nan"
spellings (reference: src/kreeq.cpp:89-104 prints QV this way;
validateFiles/test.5.tst pins "inf"/"0").
"""

import math


def cpp_double(x: float) -> str:
    """Format like std::cout << double (default precision 6)."""
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return f"{x:g}"


def cpp_fixed2(x: float) -> str:
    """Format like std::cout << std::fixed << std::setprecision(2)."""
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return f"{x:.2f}"
