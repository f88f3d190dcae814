"""Core of the port: grids, block-sparse tiles, placement, the stacked-grid
executor and the plan API (counterpart of ``repro.core``).

Import the modules directly (``repro_torch.core.api``); this package
imports nothing so that each module stays importable on its own.
"""
