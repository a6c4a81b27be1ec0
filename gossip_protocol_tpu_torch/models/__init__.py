"""Model families beyond the dense tick: the bounded partial-view
overlay (``overlay.py``), its multi-tick routes (``overlay_mega.py``,
K4; ``overlay_grid.py``, K5) and K5's schedule planner
(``segments.py``)."""
