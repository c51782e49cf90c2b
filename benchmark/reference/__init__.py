"""The plain float32 reference that decides `correct`: plain PyTorch only,
nothing of the program (`decoder.py`), and the precisions of its control
(`precision.py`)."""
