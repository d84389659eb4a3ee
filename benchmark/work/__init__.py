"""Work counted from shapes: the operations and bytes that the rooflines
and the MFU divide by the time the device took. Nothing here runs on a
device or reads a clock."""
