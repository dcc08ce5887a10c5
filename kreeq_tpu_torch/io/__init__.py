import os


def native_enabled() -> bool:
    """Native C++ runtime pieces are on by default; set
    KREEQ_TPU_NO_NATIVE=1 to force the pure-Python paths."""
    return os.environ.get("KREEQ_TPU_NO_NATIVE", "") != "1"
