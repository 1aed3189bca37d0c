"""The work of each op and model pass, counted from the shapes (and,
where the work depends on the data, the inputs) it was called with, and
the card's peaks: the yardstick of the roofline and MFU metrics."""
