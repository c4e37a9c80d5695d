"""The five example scripts of ``examples/`` as the port's entry points.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Each module takes its script's flags plus ``--device`` (default CUDA;
``cpu`` runs the plain PyTorch versions), prints its script's lines, and
keeps its work in a ``run`` function that returns the printed numbers as a
dict; ``main(argv=None)`` parses the flags and calls it.
"""
