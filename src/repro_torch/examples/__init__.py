"""The port's runnable examples, one for each of ``examples/*.py``:
``python -m repro_torch.examples.<name>``. Each runs on the card unless given
``--device cpu``; without a card the default raises."""
