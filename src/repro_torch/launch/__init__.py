"""Entry points, held against ``repro.launch``."""
