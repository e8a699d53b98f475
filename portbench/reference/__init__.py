"""The benchmark's plain reference: a Whitted frame and the light fit's
train step in plain PyTorch. It imports nothing of the program under test
and takes nothing the program made: it builds its own tables from the
benchmark's scene description (``portbench/scenes.py``)."""
