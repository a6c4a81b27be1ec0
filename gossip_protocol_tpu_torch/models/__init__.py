"""Model families beyond the dense tick: the bounded partial-view
overlay (``overlay.py``) and its multi-tick route (``overlay_mega.py``)."""
