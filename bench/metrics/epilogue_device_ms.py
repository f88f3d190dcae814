"""The epilogue's device milliseconds (``untileize``, unskew, crop): the
mean ``device_ms`` of the ``multiply.epilogue`` spans of the calls in the
traced part of the window, from the program's CUDA event pairs."""
from bench import calls


def read(run):
    times = [t for spans in calls.in_window(run).values()
             for t in calls.device_ms(spans, "multiply.epilogue")]
    return sum(times) / len(times) if times else None
