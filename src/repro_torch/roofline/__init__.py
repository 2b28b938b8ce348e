"""The port's roofline: the H100's data-sheet rates (``hw``), the useful
work of each model cell and of each hand-written kernel with the bound it
puts on a step or a call (``analysis``), and a counter of the work a torch
program does (``counts``)."""
