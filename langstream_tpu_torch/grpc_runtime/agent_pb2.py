# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: agent.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x61gent.proto\x12\x0elangstream_tpu\"*\n\x06Schema\x12\x11\n\tschema_id\x18\x01 \x01(\x05\x12\r\n\x05value\x18\x02 \x01(\x0c\"\xc1\x01\n\x05Value\x12\x16\n\x0cstring_value\x18\x01 \x01(\tH\x00\x12\x15\n\x0b\x62ytes_value\x18\x02 \x01(\x0cH\x00\x12\x14\n\njson_value\x18\x03 \x01(\tH\x00\x12\x14\n\nlong_value\x18\x04 \x01(\x03H\x00\x12\x16\n\x0c\x64ouble_value\x18\x05 \x01(\x01H\x00\x12\x14\n\nbool_value\x18\x06 \x01(\x08H\x00\x12\x14\n\navro_value\x18\x07 \x01(\x0cH\x00\x12\x11\n\tschema_id\x18\x08 \x01(\x05\x42\x06\n\x04kind\";\n\x06Header\x12\x0b\n\x03key\x18\x01 \x01(\t\x12$\n\x05value\x18\x02 \x01(\x0b\x32\x15.langstream_tpu.Value\"\xb5\x01\n\nGrpcRecord\x12\x11\n\trecord_id\x18\x01 \x01(\x03\x12\"\n\x03key\x18\x02 \x01(\x0b\x32\x15.langstream_tpu.Value\x12$\n\x05value\x18\x03 \x01(\x0b\x32\x15.langstream_tpu.Value\x12\'\n\x07headers\x18\x04 \x03(\x0b\x32\x16.langstream_tpu.Header\x12\x0e\n\x06origin\x18\x05 \x01(\t\x12\x11\n\ttimestamp\x18\x06 \x01(\x01\"\r\n\x0bInfoRequest\"!\n\x0cInfoResponse\x12\x11\n\tjson_info\x18\x01 \x01(\t\"<\n\x10PermanentFailure\x12\x11\n\trecord_id\x18\x01 \x01(\x03\x12\x15\n\rerror_message\x18\x02 \x01(\t\"g\n\rSourceRequest\x12\x19\n\x11\x63ommitted_records\x18\x01 \x03(\x03\x12;\n\x11permanent_failure\x18\x02 \x01(\x0b\x32 .langstream_tpu.PermanentFailure\"f\n\x0eSourceResponse\x12+\n\x07records\x18\x01 \x03(\x0b\x32\x1a.langstream_tpu.GrpcRecord\x12\'\n\x07schemas\x18\x02 \x03(\x0b\x32\x16.langstream_tpu.Schema\"h\n\x10ProcessorRequest\x12+\n\x07records\x18\x01 \x03(\x0b\x32\x1a.langstream_tpu.GrpcRecord\x12\'\n\x07schemas\x18\x02 \x03(\x0b\x32\x16.langstream_tpu.Schema\"o\n\x0fProcessorResult\x12\x11\n\trecord_id\x18\x01 \x01(\x03\x12+\n\x07records\x18\x02 \x03(\x0b\x32\x1a.langstream_tpu.GrpcRecord\x12\x12\n\x05\x65rror\x18\x03 \x01(\tH\x00\x88\x01\x01\x42\x08\n\x06_error\"n\n\x11ProcessorResponse\x12\x30\n\x07results\x18\x01 \x03(\x0b\x32\x1f.langstream_tpu.ProcessorResult\x12\'\n\x07schemas\x18\x02 \x03(\x0b\x32\x16.langstream_tpu.Schema\"b\n\x0bSinkRequest\x12*\n\x06record\x18\x01 \x01(\x0b\x32\x1a.langstream_tpu.GrpcRecord\x12\'\n\x07schemas\x18\x02 \x03(\x0b\x32\x16.langstream_tpu.Schema\"?\n\x0cSinkResponse\x12\x11\n\trecord_id\x18\x01 \x01(\x03\x12\x12\n\x05\x65rror\x18\x02 \x01(\tH\x00\x88\x01\x01\x42\x08\n\x06_error\"y\n\x13TopicProducerRecord\x12\r\n\x05topic\x18\x01 \x01(\t\x12*\n\x06record\x18\x02 \x01(\x0b\x32\x1a.langstream_tpu.GrpcRecord\x12\'\n\x07schemas\x18\x03 \x03(\x0b\x32\x16.langstream_tpu.Schema\"K\n\x18TopicProducerWriteResult\x12\x11\n\trecord_id\x18\x01 \x01(\x03\x12\x12\n\x05\x65rror\x18\x02 \x01(\tH\x00\x88\x01\x01\x42\x08\n\x06_error2\xb9\x03\n\x0c\x41gentService\x12I\n\nagent_info\x12\x1b.langstream_tpu.InfoRequest\x1a\x1c.langstream_tpu.InfoResponse\"\x00\x12K\n\x04read\x12\x1d.langstream_tpu.SourceRequest\x1a\x1e.langstream_tpu.SourceResponse\"\x00(\x01\x30\x01\x12T\n\x07process\x12 .langstream_tpu.ProcessorRequest\x1a!.langstream_tpu.ProcessorResponse\"\x00(\x01\x30\x01\x12H\n\x05write\x12\x1b.langstream_tpu.SinkRequest\x1a\x1c.langstream_tpu.SinkResponse\"\x00(\x01\x30\x01\x12q\n\x1aget_topic_producer_records\x12(.langstream_tpu.TopicProducerWriteResult\x1a#.langstream_tpu.TopicProducerRecord\"\x00(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'agent_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SCHEMA._serialized_start=31
  _SCHEMA._serialized_end=73
  _VALUE._serialized_start=76
  _VALUE._serialized_end=269
  _HEADER._serialized_start=271
  _HEADER._serialized_end=330
  _GRPCRECORD._serialized_start=333
  _GRPCRECORD._serialized_end=514
  _INFOREQUEST._serialized_start=516
  _INFOREQUEST._serialized_end=529
  _INFORESPONSE._serialized_start=531
  _INFORESPONSE._serialized_end=564
  _PERMANENTFAILURE._serialized_start=566
  _PERMANENTFAILURE._serialized_end=626
  _SOURCEREQUEST._serialized_start=628
  _SOURCEREQUEST._serialized_end=731
  _SOURCERESPONSE._serialized_start=733
  _SOURCERESPONSE._serialized_end=835
  _PROCESSORREQUEST._serialized_start=837
  _PROCESSORREQUEST._serialized_end=941
  _PROCESSORRESULT._serialized_start=943
  _PROCESSORRESULT._serialized_end=1054
  _PROCESSORRESPONSE._serialized_start=1056
  _PROCESSORRESPONSE._serialized_end=1166
  _SINKREQUEST._serialized_start=1168
  _SINKREQUEST._serialized_end=1266
  _SINKRESPONSE._serialized_start=1268
  _SINKRESPONSE._serialized_end=1331
  _TOPICPRODUCERRECORD._serialized_start=1333
  _TOPICPRODUCERRECORD._serialized_end=1454
  _TOPICPRODUCERWRITERESULT._serialized_start=1456
  _TOPICPRODUCERWRITERESULT._serialized_end=1531
  _AGENTSERVICE._serialized_start=1534
  _AGENTSERVICE._serialized_end=1975
# @@protoc_insertion_point(module_scope)
