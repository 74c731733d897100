# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ktpu.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nktpu.proto\x12\x04ktpu"O\n\x07Unknown\x12\x13\n\x0bapi_version\x18\x01 \x01(\t\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12\x0b\n\x03raw\x18\x03 \x01(\x0c\x12\x14\n\x0ccontent_type\x18\x04 \x01(\t"+\n\nGetRequest\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t"o\n\x0bListRequest\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\x16\n\x0elabel_selector\x18\x03 \x01(\t\x12\r\n\x05limit\x18\x04 \x01(\x05\x12\x14\n\x0ccontinue_key\x18\x05 \x01(\t"F\n\x0cListResponse\x12\x1c\n\x05items\x18\x01 \x03(\x0b2\r.ktpu.Unknown\x12\x18\n\x10resource_version\x18\x02 \x01(\t"@\n\rCreateRequest\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\x1d\n\x06object\x18\x02 \x01(\x0b2\r.ktpu.Unknown"@\n\rUpdateRequest\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\x1d\n\x06object\x18\x02 \x01(\x0b2\r.ktpu.Unknown";\n\rDeleteRequest\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\x0b\n\x03uid\x18\x03 \x01(\t"e\n\x12SubresourceRequest\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\x13\n\x0bsubresource\x18\x03 \x01(\t\x12\x1b\n\x04body\x18\x04 \x01(\x0b2\r.ktpu.Unknown"R\n\x0cWatchRequest\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\x18\n\x10resource_version\x18\x02 \x01(\t\x12\x16\n\x0elabel_selector\x18\x03 \x01(\t"I\n\nWatchEvent\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x1d\n\x06object\x18\x02 \x01(\x0b2\r.ktpu.Unknown\x12\x0e\n\x02rv\x18\x03 \x01(\tR\x02rvb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ktpu_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _UNKNOWN._serialized_start=20
  _UNKNOWN._serialized_end=99
  _GETREQUEST._serialized_start=101
  _GETREQUEST._serialized_end=144
  _LISTREQUEST._serialized_start=146
  _LISTREQUEST._serialized_end=257
  _LISTRESPONSE._serialized_start=259
  _LISTRESPONSE._serialized_end=329
  _CREATEREQUEST._serialized_start=331
  _CREATEREQUEST._serialized_end=395
  _UPDATEREQUEST._serialized_start=397
  _UPDATEREQUEST._serialized_end=461
  _DELETEREQUEST._serialized_start=463
  _DELETEREQUEST._serialized_end=522
  _SUBRESOURCEREQUEST._serialized_start=524
  _SUBRESOURCEREQUEST._serialized_end=625
  _WATCHREQUEST._serialized_start=627
  _WATCHREQUEST._serialized_end=709
  _WATCHEVENT._serialized_start=711
  _WATCHEVENT._serialized_end=784
# @@protoc_insertion_point(module_scope)
