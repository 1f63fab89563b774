"""
Fixed caption vocabularies for the CustomTokenizer, matching the reference
datasets (reference data/Cater.py:48-64 and data/CLIPort.py:38-74). These are
part of the public capability surface: token ids must match for
checkpoint-compatible text encoders.
"""

CATER_EASY_VOCAB = {
    "[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "the": 3, "cone": 4, "snitch": 5, "is": 6,
    "sliding": 7, "picked": 8, "placed": 9, "containing": 10, "rotating": 11,
    "and": 12, "to": 13, "up": 14, "(": 15, ")": 16, "1": 17, "2": 18, "3": 19,
    "-1": 20, "-2": 21, "-3": 22, ",": 23, ".": 24, "first": 25, "second": 26,
    "third": 27, "fourth": 28, "quadrant": 29,
}

CATER_HARD_VOCAB = {
    "[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "the": 3, "cone": 4, "snitch": 5, "is": 6,
    "sliding": 7, "picked": 8, "placed": 9, "containing": 10, "and": 11, "to": 12,
    "up": 13, "sphere": 14, "cylinder": 15, "cube": 16, "small": 17, "medium": 18,
    "large": 19, "metal": 20, "rubber": 21, "gold": 22, "gray": 23, "red": 24,
    "blue": 25, "green": 26, "brown": 27, "purple": 28, "cyan": 29, "yellow": 30,
    "(": 31, ")": 32, "1": 33, "2": 34, "3": 35, "-1": 36, "-2": 37, "-3": 38,
    ",": 39, ".": 40, "rotating": 41, "while": 42, "contained": 43, "still": 44,
    "first": 45, "second": 46, "third": 47, "fourth": 48, "quadrant": 49,
}

CLIPORT_VOCAB = {
    "[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "block": 3, "blue": 4, "bowl": 5,
    "brown": 6, "cyan": 7, "gray": 8, "green": 9, "in": 10, "put": 11,
    "red": 12, "the": 13, "yellow": 14,
}

# test split uses unseen colors (reference CLIPort.py:57-73)
CLIPORT_VOCAB_TEST = {
    "[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "block": 3, "blue": 4, "bowl": 5,
    "pink": 6, "purple": 7, "orange": 8, "green": 9, "in": 10, "put": 11,
    "red": 12, "the": 13, "white": 14,
}

SYNTHETIC_VOCAB = {
    "[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "the": 3, "ball": 4, "is": 5,
    "moving": 6, "up": 7, "down": 8, "left": 9, "right": 10, "red": 11,
    "green": 12, "blue": 13, "and": 14, "bouncing": 15,
}
