"""The benchmark harness of the PyTorch port: ``perfbench/run.py`` runs one
cell of ``BENCHMARK.json`` once."""
import os


def process_settings() -> None:
    """Settings of a benchmark process, made before torch starts CUDA.

    Expandable segments: the 8.8M index and the 8,192-query graph do not
    fit side by side on split segments."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
