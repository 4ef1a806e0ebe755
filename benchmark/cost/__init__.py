"""Operation and byte counts of each configuration's training epoch, one
module per configuration (``benchmark/cost/<config>.py``), counted from
the cell's inputs and widths and never from the port's packings."""
