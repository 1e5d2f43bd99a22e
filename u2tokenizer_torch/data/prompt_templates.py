"""Prompt template banks (a copy of
``u2tokenizer_tpu/data/prompt_templates.py``).

Structural counterpart of src/utils/prompt_templates.py (Caption_templates:1,
general_questions:46, PosREC_templates:132, PosREG_templates:294,
Seg_templates:421, rewrite_prompt:535). Same variable names, keys, and
format-slot contracts ({} placeholders); the phrasings are this framework's
own. Datasets sample uniformly from each bank, so bank size is free.

Slot contracts:
  * Caption_templates: one {} = the caption field ("findings"/"impression").
  * general_questions: no slot — the stage-1 MRG question bank.
  * PosREC cls_questions: {} = organ/target term; answers embed a box.
  * PosREG cls_questions: {} = a normalized box string; answers name the term.
  * Seg cls_questions: {} = organ/target term; answers acknowledge a mask.
"""

Caption_templates = [
    "Please provide a caption consisting of {} for this medical image.",
    "Write the {} for this CT volume.",
    "Summarize the {} visible in this scan.",
    "What {} can be identified in this medical image?",
    "Generate a report caption covering the {} of this scan.",
    "Describe the {} shown by this medical image.",
    "Give a detailed caption of the {} in this radiology study.",
    "What are the key {} in this medical scan?",
    "Compose a caption describing the {} of this image.",
    "Interpret the {} depicted in this medical volume.",
]

general_questions = [
    "Could you create a detailed report from the findings in this CT scan?",
    "Please write a comprehensive radiology report for this CT volume.",
    "Generate a full diagnostic report interpreting this CT scan.",
    "What does this CT scan show? Provide a complete medical report.",
    "Produce a thorough clinical report based on this CT image.",
    "Can you interpret this CT study and report the findings in detail?",
    "Draft a structured radiology report for the presented CT scan.",
    "Summarize every abnormality and normal finding in this CT volume.",
    "Write the findings section of a radiology report for this scan.",
    "Provide a detailed narrative of the findings on this CT examination.",
]

general_questions_chinese = [
    "请根据这张CT影像生成一份详细的医学报告。",
    "请解读此CT扫描并给出完整的诊断报告。",
    "请描述该CT图像中的所有发现。",
    "请为这份CT检查撰写放射学报告。",
]

PosREC_templates = {
    "cls_questions": [
        "Where is the {} in this image? Respond with a bounding box.",
        "Locate the {} in this volume and output its coordinates.",
        "Find the {} and give its 3D bounding box.",
        "Mark the {} with box coordinates in this scan.",
        "Provide the bounding box of the {} in this image.",
    ],
    "des_questions": [
        "{} — locate the structure this describes and give its bounding box.",
        "Find the region matching this description and box it: {}",
    ],
    "cls_answers": [
        "The {} is located at {}.",
        "Bounding box of the {}: {}.",
        "It is here: {} occupies {}.",
    ],
    "des_answers": [
        "That description matches the {}, at {}.",
        "The described structure is the {}; its box is {}.",
    ],
}

PosREG_templates = {
    "cls_questions": [
        "What target is present within the coordinates {}?",
        "Which structure occupies the region {}?",
        "Identify the object inside the bounding box {}.",
        "Name what is contained in the box {}.",
        "What anatomy lies within {}?",
    ],
    "cls_answers": [
        "The region {} contains the {}.",
        "Within {} is the {}.",
        "That box {} covers the {}.",
    ],
}

Seg_templates = {
    "cls_questions": [
        "Can you segment the {} in this image?",
        "Please produce a segmentation mask for the {}.",
        "Segment the {} in this volume and output the mask.",
        "Extract the {} region as a segmentation mask.",
        "Delineate the {} in this scan.",
    ],
    "des_questions": [
        "{} — segment the structure this describes.",
        "Based on this description, output the mask: {}",
    ],
    "cls_answers": [
        "Here is the segmentation of the {}: [SEG].",
        "The {} mask is [SEG].",
    ],
    "des_answers": [
        "The description matches the {}; its mask is [SEG].",
    ],
}

rewrite_prompt = (
    "You are an expert CT radiologist. Rewrite the following CT report so the "
    "wording is fluent and professional while every clinical statement keeps "
    "its exact meaning: do not add, remove, soften, or strengthen any "
    "finding. Merge the findings and impression into one coherent paragraph. "
    "Reply with only the rewritten report."
)

translate_prompt = (
    "Translate the following radiology report between Chinese and English, "
    "preserving every clinical detail exactly. Reply with only the "
    "translation."
)

qa_generation_prompt = (
    "You are a radiology teaching assistant. Given the CT report below, "
    "write {n} question-answer pairs that can be answered solely from the "
    "report. Return a JSON list of objects with 'question' and 'answer' "
    "fields and nothing else."
)
