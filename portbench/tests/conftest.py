"""Every test leaves the program's recorder off: loading a reader of the
program's spans and counters switches it on."""
import pytest


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    from pylabfea_tpu_torch.utils import profiling
    if hasattr(profiling, 'stop'):
        profiling.stop()
