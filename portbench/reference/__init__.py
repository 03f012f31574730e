"""The benchmark's plain reference: the frames the program must deliver,
written with nothing of the program (H.264 syntax on bit strings)."""
