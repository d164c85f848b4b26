"""Training of the port: the state (``state.py``) and the step and its loop
(``trainer.py``)."""
