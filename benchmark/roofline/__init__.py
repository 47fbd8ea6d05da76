"""The yardstick's roofline: published peaks of the card, and the work of
each measured kernel sweep counted from its configuration, never from a
count the program makes."""
