"""The plain reference: each model family's forward and its SIGE sparse
step in dense PyTorch (``common.Pass``), and the window layout's
canonical windows worked out again from the masks (``windows``). It
imports nothing of the program."""
