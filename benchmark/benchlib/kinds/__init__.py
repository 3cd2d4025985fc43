"""The kinds of traffic: each drives one entry of the program through
set-up, a measured window and the check of what the window produced.
A traffic file names its kind; its other keys are the kind's parameters."""
