"""Roofline of the port on the H100: the card's numbers (`hw`), the
roofline terms and model FLOPs (`analysis`), FLOP and byte counts of a
port function's ops (`op_stats`) and the report over every shape cell
(`report`)."""
